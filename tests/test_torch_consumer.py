"""Twin of ``tests/test_consumer.py`` on the port: the consumer client of
``repro_torch.core`` (cursor, atomic visibility, remap properties, read
amplification, prefetch eviction). Imports neither jax nor msgpack.
"""
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

pytest.importorskip("torch")

from repro_torch.core import (Consumer, ManifestStore,  # noqa: E402
                              MemoryObjectStore, MeshPosition, Namespace,
                              Producer, remap_step)


@pytest.fixture
def store():
    """The port's store (shadows the reference's in conftest)."""
    return MemoryObjectStore()


@pytest.fixture
def ns(store):
    """The port's namespace (shadows the reference's in conftest)."""
    return Namespace(store, "runs/test")


def _filled_ns(n_tgbs=8, dp=2, cp=2, slice_bytes=64):
    store = MemoryObjectStore()
    ns = Namespace(store, "runs/c")
    p = Producer(ns, "p0", dp=dp, cp=cp, manifests=ManifestStore(ns))
    for _ in range(n_tgbs):
        p.write_tgb(uniform_slice_bytes=slice_bytes)
        p.maybe_commit(force=True)
    p.finalize()
    return ns


def test_all_ranks_see_identical_step_sequence():
    ns = _filled_ns(n_tgbs=6, dp=2, cp=2)
    seen = {}
    for d in range(2):
        for c in range(2):
            cons = Consumer(ns, MeshPosition(d, c, 2, 2))
            seen[(d, c)] = [cons.next_batch(1.0) for _ in range(6)]
            assert cons.cursor[1] == 6
    # per-step: the 4 ranks read 4 distinct slices (disjoint data)
    for s in range(6):
        payloads = [seen[k][s] for k in seen]
        assert len(set(payloads)) == len(payloads) or \
            all(len(p) > 0 for p in payloads)


def test_unpublished_step_blocks_then_times_out():
    ns = _filled_ns(n_tgbs=2)
    cons = Consumer(ns, MeshPosition(0, 0, 2, 2))
    cons.next_batch(1.0)
    cons.next_batch(1.0)
    with pytest.raises(TimeoutError):
        cons.next_batch(timeout_s=0.2)


def test_cursor_restore_replays_exactly():
    ns = _filled_ns(n_tgbs=6)
    cons = Consumer(ns, MeshPosition(0, 0, 2, 2))
    first = [cons.next_batch(1.0) for _ in range(4)]
    v, s = cons.cursor
    cons2 = Consumer(ns, MeshPosition(0, 0, 2, 2))
    cons2.restore_cursor(v, 2)
    replay = [cons2.next_batch(1.0) for _ in range(2)]
    assert replay == first[2:4]


def test_read_amplification_near_one_for_large_slices():
    ns = _filled_ns(n_tgbs=4, slice_bytes=100_000)
    cons = Consumer(ns, MeshPosition(0, 0, 2, 2))
    for _ in range(4):
        cons.next_batch(1.0)
    assert cons.stats.read_amplification < 1.05


def test_dense_read_amplifies_by_world_size():
    ns = _filled_ns(n_tgbs=4, dp=2, cp=2, slice_bytes=100_000)
    cons = Consumer(ns, MeshPosition(0, 0, 2, 2), dense_read=True)
    for _ in range(4):
        cons.next_batch(1.0)
    assert cons.stats.read_amplification > 3.5  # ~DxC = 4


def test_prefetch_hits(ns):
    nsf = _filled_ns(n_tgbs=8)
    cons = Consumer(nsf, MeshPosition(0, 0, 2, 2), prefetch_depth=4)
    cons.poll()
    cons.start_prefetch()
    import time
    time.sleep(0.3)
    for _ in range(8):
        cons.next_batch(1.0)
    cons.stop_prefetch()
    assert cons.stats.prefetch_hits > 0


# ---------------------------------------------------------------------------
# Topology remap (paper §4.1)
# ---------------------------------------------------------------------------

@settings(max_examples=60, deadline=None)
@given(tgb_dp=st.sampled_from([1, 2, 4, 8]),
       factor=st.sampled_from([1, 2, 4]),
       grow=st.booleans(), steps=st.integers(1, 12))
def test_remap_covers_all_slices_exactly_once(tgb_dp, factor, grow, steps):
    """Property: over any consecutive logical-step window, the union of
    (tgb_step, slice) reads across all new-topology ranks covers each
    materialized slice exactly once, in order."""
    new_dp = tgb_dp * factor if grow else max(1, tgb_dp // factor)
    cp = 1
    reads = {}
    for s in range(steps):
        for d in range(new_dp):
            pos = MeshPosition(d, 0, new_dp, cp)
            t, td, tc = remap_step(s, pos, tgb_dp, cp)
            key = (t, td, tc)
            assert key not in reads, f"slice {key} read twice"
            reads[key] = (s, d)
    # coverage: consumed tgb steps form a contiguous prefix of slices
    per_tgb = {}
    for (t, td, tc) in reads:
        per_tgb.setdefault(t, set()).add(td)
    consumed_fully = [t for t, ds in per_tgb.items() if len(ds) == tgb_dp]
    # all fully consumed TGBs must be a prefix 0..k
    if consumed_fully:
        assert sorted(consumed_fully) == list(range(max(consumed_fully) + 1))


def test_remap_identity():
    pos = MeshPosition(3, 1, 8, 2)
    assert remap_step(5, pos, 8, 2) == (5, 3, 1)


def test_remap_dp_double():
    # DP 2 -> 4: logical step s reads two consecutive TGBs
    assert remap_step(0, MeshPosition(0, 0, 4, 1), 2, 1) == (0, 0, 0)
    assert remap_step(0, MeshPosition(1, 0, 4, 1), 2, 1) == (0, 1, 0)
    assert remap_step(0, MeshPosition(2, 0, 4, 1), 2, 1) == (1, 0, 0)
    assert remap_step(0, MeshPosition(3, 0, 4, 1), 2, 1) == (1, 1, 0)
    assert remap_step(1, MeshPosition(0, 0, 4, 1), 2, 1) == (2, 0, 0)


def test_remap_dp_halve():
    # DP 4 -> 2: one TGB serves two logical steps
    assert remap_step(0, MeshPosition(0, 0, 2, 1), 4, 1) == (0, 0, 0)
    assert remap_step(0, MeshPosition(1, 0, 2, 1), 4, 1) == (0, 1, 0)
    assert remap_step(1, MeshPosition(0, 0, 2, 1), 4, 1) == (0, 2, 0)
    assert remap_step(1, MeshPosition(1, 0, 2, 1), 4, 1) == (0, 3, 0)
    assert remap_step(2, MeshPosition(0, 0, 2, 1), 4, 1) == (1, 0, 0)


def test_remap_rejects_non_integer_factors():
    with pytest.raises(ValueError):
        remap_step(0, MeshPosition(0, 0, 3, 1), 2, 1)


def test_tp_pp_transparent():
    """Ranks in the same (d, c) group (any TP/PP degree) read identical data."""
    ns = _filled_ns(n_tgbs=2, dp=2, cp=2)
    a = Consumer(ns, MeshPosition(1, 1, 2, 2))
    b = Consumer(ns, MeshPosition(1, 1, 2, 2))  # a TP peer: same coords
    assert a.next_batch(1.0) == b.next_batch(1.0)


def test_prefetch_eviction_keeps_next_needed_slice():
    """After a cursor restore, overflow eviction must drop the farthest-ahead
    stale entries, not the slice the consumer is about to read."""
    ns = _filled_ns(n_tgbs=12, dp=1, cp=1)
    cons = Consumer(ns, MeshPosition(0, 0, 1, 1), prefetch_depth=2)
    # simulate leftovers from before a backward restore (steps 8..11) plus
    # freshly prefetched near-cursor entries (steps 0..2)
    cons.step = 0
    for s in (8, 9, 10, 11, 0, 1, 2):
        cons._prefetched[(s, 0, 0)] = b"x"
    with cons._prefetch_lock:
        cons._evict_overflow()
    kept = sorted(k[0] for k in cons._prefetched)
    assert len(kept) == cons.prefetch_depth + 2
    assert kept == [0, 1, 2, 8]  # far-ahead stale steps evicted first

    # stale *below*-cursor leftovers (slow prefetch landing after a direct
    # fetch) go first of all — nothing would ever pop them otherwise
    cons.step = 9
    cons._prefetched.clear()
    for s in (0, 1, 2, 3, 9, 10, 11):
        cons._prefetched[(s, 0, 0)] = b"x"
    with cons._prefetch_lock:
        cons._evict_overflow()
    kept = sorted(k[0] for k in cons._prefetched)
    assert len(kept) == cons.prefetch_depth + 2
    assert set(kept) >= {9, 10, 11}  # the live window survives intact


def test_consumer_stats_latencies_bounded_window():
    from repro_torch.core import LatencyWindow

    ns = _filled_ns(n_tgbs=4, dp=1, cp=1)
    cons = Consumer(ns, MeshPosition(0, 0, 1, 1))
    for _ in range(4):
        cons.next_batch(1.0)
    lats = cons.stats.read_latencies
    assert isinstance(lats, LatencyWindow)
    assert lats.count == 4 and len(lats) == 4
    assert all(t >= 0 for t in lats)
