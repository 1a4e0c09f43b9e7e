"""Twin of ``tests/test_lifecycle.py`` on the port: checkpoint-aligned
lifecycle of ``repro_torch.core`` (watermarks, reclamation safety,
``max_lag``). Imports neither jax nor msgpack.
"""
import pytest

pytest.importorskip("torch")

from repro_torch.core import (Consumer, ManifestStore,  # noqa: E402
                              MemoryObjectStore, MeshPosition, Namespace,
                              Producer, Reclaimer, Watermark, global_watermark,
                              write_watermark)


@pytest.fixture
def store():
    """The port's store (shadows the reference's in conftest)."""
    return MemoryObjectStore()


@pytest.fixture
def ns(store):
    """The port's namespace (shadows the reference's in conftest)."""
    return Namespace(store, "runs/test")


def _run(ns, n_tgbs=10, dp=2):
    p = Producer(ns, "p0", dp=dp, cp=1, manifests=ManifestStore(ns))
    for _ in range(n_tgbs):
        p.write_tgb(uniform_slice_bytes=256)
        p.maybe_commit(force=True)
    p.finalize()
    return p


def test_global_watermark_is_min(ns):
    write_watermark(ns, 0, Watermark(version=5, step=8))
    write_watermark(ns, 1, Watermark(version=3, step=6))
    wg = global_watermark(ns)
    assert wg == Watermark(version=3, step=6)


def test_global_watermark_waits_for_all_ranks(ns):
    write_watermark(ns, 0, Watermark(version=5, step=8))
    assert global_watermark(ns, expected_ranks=2) is None


def test_reclaim_frees_bytes_and_preserves_live_data(ns):
    _run(ns, n_tgbs=10)
    store = ns.store
    before = store.total_bytes()
    # both ranks checkpointed at step 6
    write_watermark(ns, 0, Watermark(version=9, step=6))
    write_watermark(ns, 1, Watermark(version=9, step=6))
    r = Reclaimer(ns, expected_ranks=2)
    wg = r.run_cycle()
    assert wg.step == 6
    assert r.stats.tgbs_deleted == 6
    assert store.total_bytes() < before
    # steps >= 6 still consumable after rollback to the checkpoint
    cons = Consumer(ns, MeshPosition(0, 0, 2, 1))
    cons.restore_cursor(9, 6)
    for _ in range(4):
        cons.next_batch(1.0)


def test_reclaim_is_idempotent(ns):
    _run(ns, n_tgbs=6)
    write_watermark(ns, 0, Watermark(version=5, step=4))
    r = Reclaimer(ns, expected_ranks=1)
    r.run_cycle()
    deleted_once = r.stats.tgbs_deleted
    r.run_cycle()
    assert r.stats.tgbs_deleted == deleted_once


def test_no_reclaim_without_physical_delete(ns):
    _run(ns, n_tgbs=6)
    before = ns.store.total_bytes()
    write_watermark(ns, 0, Watermark(version=5, step=4))
    r = Reclaimer(ns, expected_ranks=1, physical_delete=False)
    r.run_cycle()
    # logical trim only: nothing deleted (the trim marker itself is written)
    assert r.stats.tgbs_deleted == 0 and r.stats.manifests_deleted == 0
    assert ns.store.total_bytes() >= before
    step, version = r.read_trim()
    assert step == 4


def test_logical_trim_applied_at_next_commit(ns):
    p = _run(ns, n_tgbs=6)
    write_watermark(ns, 0, Watermark(version=5, step=4))
    Reclaimer(ns, expected_ranks=1).run_cycle()
    safe_step, _ = Reclaimer(ns).read_trim()
    p.write_tgb(uniform_slice_bytes=256)
    # producer applies the trim marker at its next commit
    res = p.protocol.try_commit(p.pending, trim_to_step=safe_step)[0]
    assert res.success
    view = ManifestStore(ns).load_view(res.version)
    assert view.base_step == 4


def test_max_lag_throttles_producer(ns):
    p = Producer(ns, "p0", dp=1, cp=1, manifests=ManifestStore(ns), max_lag=4)
    for _ in range(4):
        p.write_tgb(uniform_slice_bytes=64)
        p.maybe_commit(force=True)
    p.finalize()
    # no watermark yet -> trim at 0 -> 4 published >= max_lag
    assert p.lag_exceeded()
    write_watermark(ns, 0, Watermark(version=10, step=3))
    Reclaimer(ns, expected_ranks=1, physical_delete=False).run_cycle()
    assert not p.lag_exceeded()  # 4 + 0 pending - 3 consumed < 4


def test_background_reclaimer_thread(ns):
    _run(ns, n_tgbs=6)
    write_watermark(ns, 0, Watermark(version=5, step=4))
    r = Reclaimer(ns, expected_ranks=1)
    r.start(interval_s=0.05)
    import time
    time.sleep(0.3)
    r.stop()
    assert r.stats.cycles >= 2
    assert r.stats.tgbs_deleted == 4
