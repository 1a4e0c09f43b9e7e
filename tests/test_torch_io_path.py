"""Twin of ``tests/test_io_path.py`` on the port: the pipelined zero-copy I/O
path of ``repro_torch.core`` (coalesced vectored reads, speculative footer
opens, incremental manifest decode, parallel prefetch, pipelined commits).
Imports neither jax nor msgpack.
"""
import threading

import pytest

pytest.importorskip("torch")

from repro_torch.core import (Consumer, DACConfig, DACPolicy,  # noqa: E402
                              IOPool, ManifestStore, MemoryObjectStore,
                              MeshPosition, NaivePolicy, Namespace, Producer,
                              TGBReader, coalesce_ranges)
from repro_torch.core.manifest import MANIFEST_FORMAT_FLAT  # noqa: E402
from repro_torch.core.tgb import (TGBBuilder, TGBFormatError,  # noqa: E402
                                  build_uniform_tgb)


@pytest.fixture
def store():
    """The port's store (shadows the reference's in conftest)."""
    return MemoryObjectStore()


@pytest.fixture
def ns(store):
    """The port's namespace (shadows the reference's in conftest)."""
    return Namespace(store, "runs/test")


# ---------------------------------------------------------------------------
# get_ranges / coalescing
# ---------------------------------------------------------------------------

def test_coalesce_ranges_groups_by_gap():
    groups = coalesce_ranges([(0, 10), (20, 5), (10_000, 3)], gap_threshold=100)
    assert [(g[0], g[1]) for g in groups] == [(0, 25), (10_000, 3)]
    # members carry original indices
    assert [m[0] for m in groups[0][2]] == [0, 1]


def test_coalesce_ranges_preserves_request_order(store):
    store.put("k", bytes(range(256)))
    # out-of-order, overlapping, duplicate ranges all come back in input order
    ranges = [(100, 10), (0, 4), (100, 10), (50, 20), (60, 5)]
    views = store.get_ranges("k", ranges, gap_threshold=4096)
    for (off, ln), view in zip(ranges, views):
        assert bytes(view) == bytes(range(256))[off:off + ln]


def test_get_ranges_byte_equivalent_to_scalar_reads(store):
    blob = bytes(i % 251 for i in range(100_000))
    store.put("k", blob)
    ranges = [(0, 100), (200, 50), (99_000, 1000), (40_000, 1)]
    vec = store.get_ranges("k", ranges)
    for (off, ln), view in zip(ranges, vec):
        assert bytes(view) == store.get_range("k", off, ln)


def test_get_ranges_charges_one_request_per_group(store):
    store.put("k", bytes(10_000))
    before = store.stats.range_gets
    store.get_ranges("k", [(0, 10), (100, 10), (200, 10)], gap_threshold=512)
    assert store.stats.range_gets == before + 1  # one coalesced request
    assert store.stats.coalesced_requests == 1
    assert store.stats.coalesced_ranges == 3
    before = store.stats.range_gets
    store.get_ranges("k", [(0, 10), (9_000, 10)], gap_threshold=64)
    assert store.stats.range_gets == before + 2  # gap too large: two requests


def test_get_ranges_counts_gap_bytes_as_read(store):
    store.put("k", bytes(10_000))
    before = store.stats.bytes_read
    store.get_ranges("k", [(0, 10), (100, 10)], gap_threshold=512)
    assert store.stats.bytes_read - before == 110  # span incl. 90 gap bytes


# ---------------------------------------------------------------------------
# TGB reader: speculative footer + read_slices
# ---------------------------------------------------------------------------

def _tgb(store, dp=2, cp=4, slice_bytes=512, key="t/x.tgb"):
    store.put(key, build_uniform_tgb("t0", dp, cp, "p", 0, slice_bytes))
    return key


def test_speculative_footer_is_one_request(store):
    key = _tgb(store)
    before = store.stats.range_gets
    r = TGBReader(store, key)
    footer = r.footer()
    assert store.stats.range_gets == before + 1
    assert footer.dp == 2 and footer.cp == 4
    assert r.footer_overhead_bytes > 0


def test_speculative_footer_fallback_when_footer_exceeds_window(store):
    key = _tgb(store)
    full = TGBReader(store, key).footer()
    # window smaller than the footer: exact fallback read of the prefix
    r = TGBReader(store, key, speculative_tail=24)
    before = store.stats.range_gets
    assert r.footer() == full
    assert store.stats.range_gets == before + 2  # window + missing prefix


def test_speculative_footer_window_larger_than_object(store):
    key = _tgb(store, dp=1, cp=1, slice_bytes=8)  # object far below 4 KiB
    r = TGBReader(store, key)
    assert r.footer().slices[0][1] == 8
    assert r.read_slice(0, 0) == build_uniform_tgb("t0", 1, 1, "p", 0, 8)[:8]


def test_scalar_mode_matches_legacy_two_request_open(store):
    key = _tgb(store)
    before = store.stats.range_gets
    r = TGBReader(store, key, speculative_tail=0)
    footer = r.footer()
    assert store.stats.range_gets == before + 2  # tail, then exact footer
    assert footer == TGBReader(store, key).footer()


def test_read_slices_byte_equivalent_to_sequential(store):
    b = TGBBuilder("t0", dp=2, cp=4, producer_id="p", producer_seq=0)
    for d in range(2):
        for c in range(4):
            b.add_slice(d, c, bytes([d * 16 + c]) * (64 + 8 * c))
    store.put("k", b.build())
    r = TGBReader(store, "k")
    for d in range(2):
        for c_start, span in ((0, 4), (1, 2), (3, 1)):
            want = b"".join(r.read_slice(d, c_start + i) for i in range(span))
            assert r.read_slices(d, c_start, span) == want


def test_read_slices_is_one_coalesced_request(store):
    key = _tgb(store, slice_bytes=1024)
    r = TGBReader(store, key)
    r.footer()
    before = store.stats.range_gets
    r.read_slices(0, 0, 4)
    assert store.stats.range_gets == before + 1


def test_read_slices_crc_verifies_each_view(store):
    key = _tgb(store, dp=1, cp=2, slice_bytes=64)
    blob = bytearray(store.get("t/x.tgb"))
    blob[70] ^= 0xFF  # corrupt a byte inside slice (0, 1)
    store.put(key, bytes(blob))
    r = TGBReader(store, key)
    with pytest.raises(TGBFormatError, match="crc"):
        r.read_slices(0, 0, 2)
    assert r.read_slices(0, 0, 2, verify=False)


def test_small_tgb_slice_served_from_footer_window(store):
    key = _tgb(store, dp=2, cp=1, slice_bytes=100)
    r = TGBReader(store, key)
    r.footer()
    before = store.stats.range_gets
    data = r.read_slice(1, 0)
    assert store.stats.range_gets == before  # zero-copy from the tail window
    assert r.last_fetch_bytes == 0
    assert data == TGBReader(store, key, speculative_tail=0).read_slice(1, 0)


def test_consumer_adapts_footer_window_to_small_tgbs():
    ns = _filled_ns(MemoryObjectStore(), n_tgbs=4, dp=2, cp=1, slice_bytes=512)
    cons = Consumer(ns, MeshPosition(0, 0, 2, 1))
    for _ in range(4):
        cons.next_batch(5.0)
    # after the first footer open the speculative window shrinks to the
    # observed footer size (+margin), keeping amplification modest even
    # for tiny TGBs where a fixed 4 KiB window would dominate
    assert cons._window_hint is not None and cons._window_hint < 1024
    assert cons.stats.read_amplification < 2.0


# ---------------------------------------------------------------------------
# Incremental flat manifest decode
# ---------------------------------------------------------------------------

def _commit_n(p, n):
    for _ in range(n):
        p.write_tgb(uniform_slice_bytes=32)
        p.maybe_commit(force=True)


def test_flat_incremental_decode_preserves_descriptor_identity(ns):
    m = ManifestStore(ns, fmt=MANIFEST_FORMAT_FLAT)
    p = Producer(ns, "p0", dp=1, cp=1, policy=NaivePolicy(), manifests=m)
    _commit_n(p, 4)
    base = m.load_view(m.latest_version())
    _commit_n(p, 3)
    advanced = m.load_view(m.latest_version(), base=base)
    # O(new) poll cost: the unchanged prefix reuses the base's objects
    assert advanced.total_steps == 7
    for i, desc in enumerate(base.tgbs):
        assert advanced.tgbs[i] is desc
    assert advanced.version > base.version


def test_flat_incremental_decode_equivalent_to_cold_load_under_trim(ns):
    m = ManifestStore(ns, fmt=MANIFEST_FORMAT_FLAT)
    p = Producer(ns, "p0", dp=1, cp=1, policy=NaivePolicy(), manifests=m)
    _commit_n(p, 5)
    base = m.load_view(m.latest_version())
    # next commits trim the first 3 steps while appending new TGBs
    p.write_tgb(uniform_slice_bytes=32)
    p.maybe_commit(trim_to_step=3, force=True)
    _commit_n(p, 2)
    v = m.latest_version()
    warm = m.load_view(v, base=base)
    cold = ManifestStore(ns, fmt=MANIFEST_FORMAT_FLAT).load_view(v)
    assert warm.version == cold.version
    assert warm.base_step == cold.base_step == 3
    assert [t.tgb_id for t in warm.tgbs] == [t.tgb_id for t in cold.tgbs]
    assert warm.producers == cold.producers
    # surviving overlap still reuses base objects (steps 3..4 of the base)
    assert warm.tgbs[0] is base.tgbs[3]
    assert warm.tgbs[1] is base.tgbs[4]


def test_flat_incremental_decode_ignores_misaligned_base(ns):
    m = ManifestStore(ns, fmt=MANIFEST_FORMAT_FLAT)
    p = Producer(ns, "p0", dp=1, cp=1, policy=NaivePolicy(), manifests=m)
    _commit_n(p, 3)
    v = m.latest_version()
    cold = m.load_view(v)
    # a base from a different namespace/history must not poison the decode
    other_ns = Namespace(ns.store, "runs/other")
    m2 = ManifestStore(other_ns, fmt=MANIFEST_FORMAT_FLAT)
    p2 = Producer(other_ns, "q0", dp=1, cp=1, policy=NaivePolicy(),
                  manifests=m2)
    _commit_n(p2, 3)
    alien = m2.load_view(m2.latest_version())
    mixed = m.load_view(v, base=alien)
    assert [t.tgb_id for t in mixed.tgbs] == [t.tgb_id for t in cold.tgbs]
    assert all(a is not b for a, b in zip(mixed.tgbs, alien.tgbs))


# ---------------------------------------------------------------------------
# Consumer: parallel prefetch + coalesced spans + poll rate limiting
# ---------------------------------------------------------------------------

def _filled_ns(store, n_tgbs=8, dp=2, cp=4, slice_bytes=64):
    ns = Namespace(store, "runs/io")
    p = Producer(ns, "p0", dp=dp, cp=cp, policy=NaivePolicy(),
                 manifests=ManifestStore(ns))
    for _ in range(n_tgbs):
        p.write_tgb(uniform_slice_bytes=slice_bytes)
        p.maybe_commit(force=True)
    p.finalize()
    return ns


def test_coalesced_consumer_matches_scalar_consumer_bytes():
    # realistic slice sizes: the 4 KiB speculative footer over-read must stay
    # a rounding error in the amplification accounting
    ns = _filled_ns(MemoryObjectStore(), n_tgbs=6, slice_bytes=100_000)
    for cp_size in (1, 2, 4):  # spans 4, 2, 1
        fast = Consumer(ns, MeshPosition(0, 0, 2, cp_size))
        slow = Consumer(ns, MeshPosition(0, 0, 2, cp_size),
                        parallel_prefetch=False, coalesce_reads=False,
                        speculative_tail=0)
        for _ in range(6):
            assert fast.next_batch(5.0) == slow.next_batch(5.0)
        assert fast.stats.read_amplification < 1.1


def test_parallel_prefetch_serves_identical_data():
    ns = _filled_ns(MemoryObjectStore(), n_tgbs=8)
    direct = Consumer(ns, MeshPosition(0, 1, 2, 4))
    want = [direct.next_batch(5.0) for _ in range(8)]
    pool = IOPool(max_workers=4, name="test-io")
    try:
        cons = Consumer(ns, MeshPosition(0, 1, 2, 4), io_pool=pool,
                        prefetch_depth=4)
        cons.poll()
        cons.start_prefetch()
        try:
            got = [cons.next_batch(5.0) for _ in range(8)]
        finally:
            cons.stop_prefetch()
    finally:
        pool.shutdown()
    assert got == want
    assert cons.stats.prefetch_hits > 0


def test_prefetch_poll_rate_limited_when_producer_stalls():
    store = MemoryObjectStore()
    ns = _filled_ns(store, n_tgbs=2)
    cons = Consumer(ns, MeshPosition(0, 0, 2, 4), min_poll_interval_s=10.0)
    cons.poll()
    cons.next_batch(5.0)
    cons.next_batch(5.0)  # caught up; producer now "stalled"
    polls_before = cons.stats.manifest_polls
    cons.start_prefetch()
    try:
        deadline = threading.Event()
        deadline.wait(0.25)  # let the prefetch loop spin against the stall
    finally:
        cons.stop_prefetch()
    # with a 10s minimum interval the spinning loop gets at most one probe
    assert cons.stats.manifest_polls - polls_before <= 1


# ---------------------------------------------------------------------------
# Producer: pipelined commits
# ---------------------------------------------------------------------------

def test_pipelined_commits_publish_all_tgbs_exactly_once(ns):
    pool = IOPool(max_workers=2, name="test-commit")
    try:
        p = Producer(ns, "p0", dp=1, cp=1, policy=NaivePolicy(),
                     manifests=ManifestStore(ns), pipeline_commits=True,
                     io_pool=pool)
        for _ in range(10):
            p.write_tgb(uniform_slice_bytes=32)
            p.maybe_commit()
        p.finalize()
    finally:
        pool.shutdown()
    m = ManifestStore(ns)
    view = m.load_view(m.latest_version())
    assert [t.producer_seq for t in view.tgbs] == list(range(10))
    assert view.producer_offset("p0") == 9
    assert p.stats.tgbs_committed == 10


def test_pipelined_commits_survive_conflicts(ns):
    pool = IOPool(max_workers=4, name="test-commit2")
    try:
        ps = [Producer(ns, f"p{i}", dp=1, cp=1, policy=NaivePolicy(),
                       manifests=ManifestStore(ns), pipeline_commits=True,
                       io_pool=pool)
              for i in range(3)]

        def produce(p):
            for _ in range(6):
                p.write_tgb(uniform_slice_bytes=16)
                p.maybe_commit()
            p.finalize()

        threads = [threading.Thread(target=produce, args=(p,)) for p in ps]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
    finally:
        pool.shutdown()
    m = ManifestStore(ns)
    view = m.load_view(m.latest_version())
    # every TGB exactly once, per-producer order preserved
    assert len(view.tgbs) == 18
    for i in range(3):
        seqs = [t.producer_seq for t in view.tgbs if t.producer_id == f"p{i}"]
        assert seqs == list(range(6))


# ---------------------------------------------------------------------------
# Satellites
# ---------------------------------------------------------------------------

def test_dac_policy_configs_are_not_shared():
    a, b = DACPolicy(), DACPolicy()
    assert a.cfg is not b.cfg
    a.cfg.eps = 0.5
    assert b.cfg.eps == DACConfig().eps


def test_manifest_raw_cache_eviction_uses_deque(ns):
    m = ManifestStore(ns)
    m._raw_cache_cap = 4
    p = Producer(ns, "p0", dp=1, cp=1, policy=NaivePolicy(),
                 manifests=ManifestStore(ns))
    _commit_n(p, 8)
    for v in range(8):
        m.read_doc(v)
    assert len(m._raw_cache) <= 4
    assert list(m._raw_cache_order) == [4, 5, 6, 7]
    assert hasattr(m._raw_cache_order, "popleft")
