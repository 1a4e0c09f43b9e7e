"""Twin of ``tests/test_manifest_commit.py`` on the port: the flat and delta
manifest codecs and the commit/rebase protocol of ``repro_torch.core``
(linearizability, no lost TGBs). Imports neither jax nor msgpack: the
port's ``core/_msgpack.py`` is the only codec here.
"""
import threading

import pytest

pytest.importorskip("torch")

from repro_torch.core import (CommitProtocol, ManifestStore,  # noqa: E402
                              MemoryObjectStore, Namespace, Producer)
from repro_torch.core.manifest import (MANIFEST_FORMAT_DELTA,  # noqa: E402
                                       MANIFEST_FORMAT_FLAT, DatasetView)
from repro_torch.core.tgb import TGBDescriptor  # noqa: E402


@pytest.fixture
def store():
    """The port's store (shadows the reference's in conftest)."""
    return MemoryObjectStore()


@pytest.fixture
def ns(store):
    """The port's namespace (shadows the reference's in conftest)."""
    return Namespace(store, "runs/test")


def _desc(pid, seq):
    return TGBDescriptor(
        tgb_id=f"{pid}-{seq}", object_key=f"tgb/{pid}/{seq}", size_bytes=10,
        dp=1, cp=1, num_samples=1, token_count=8, producer_id=pid,
        producer_seq=seq)


@pytest.mark.parametrize("fmt", [MANIFEST_FORMAT_FLAT, MANIFEST_FORMAT_DELTA])
def test_commit_appends_and_orders(ns, fmt):
    ms = ManifestStore(ns, fmt=fmt, snapshot_every=4)
    proto = CommitProtocol(ms, "p0")
    for seq in range(10):
        res, still = proto.try_commit([_desc("p0", seq)])
        assert res.success and not still
    view = ms.load_view(ms.latest_version())
    assert view.total_steps == 10
    assert [t.producer_seq for t in view.tgbs] == list(range(10))
    assert view.producer_offset("p0") == 9


@pytest.mark.parametrize("fmt", [MANIFEST_FORMAT_FLAT, MANIFEST_FORMAT_DELTA])
def test_flat_and_delta_views_agree(ns, fmt):
    ms = ManifestStore(ns, fmt=fmt, snapshot_every=3)
    p0 = CommitProtocol(ms, "p0")
    p1 = CommitProtocol(ms, "p1")

    def commit_retry(proto, descs):
        pending = descs
        for _ in range(4):
            res, pending = proto.try_commit(pending)
            if res.success:
                return res
        raise AssertionError("commit did not converge")

    for seq in range(7):
        commit_retry(p0, [_desc("p0", seq)])
        p1.refresh()
        commit_retry(p1, [_desc("p1", seq)])
    # cold reconstruction equals incremental
    cold = ManifestStore(ns, fmt=fmt).load_view(ms.latest_version())
    assert cold.total_steps == 14
    assert cold.producer_offset("p0") == 6
    assert cold.producer_offset("p1") == 6


def test_rebase_preserves_all_committed_tgbs(ns):
    """Force a true conditional-put race (A steals B's version AFTER B's
    attempt-start read) and check the rebase's append-only union merge."""
    ms = ManifestStore(ns)
    a = CommitProtocol(ms, "A")
    b = CommitProtocol(ms, "B")
    assert a.try_commit([_desc("A", 0)])[0].success
    b.refresh()
    # A wins version 1 inside B's fragile window
    assert a.try_commit([_desc("A", 1)])[0].success
    version, raw = ms.encode_candidate(
        b.view, [_desc("B", 0)],
        {**b.view.producers}, trim_to_step=None)
    assert not ms.try_put_version(version, raw)  # B loses the race
    # rebase path: the normal try_commit now lands on the winner
    res, still = b.try_commit([_desc("B", 0)])
    assert res.success and not still
    view = ms.load_view(ms.latest_version())
    assert {(t.producer_id, t.producer_seq) for t in view.tgbs} == {
        ("A", 0), ("A", 1), ("B", 0)}


def test_rebase_dedups_own_committed_tgbs(ns):
    """Exactly-once: a TGB visible in the winner manifest is never re-appended."""
    ms = ManifestStore(ns)
    a = CommitProtocol(ms, "A")
    assert a.try_commit([_desc("A", 0), _desc("A", 1)])[0].success
    # simulate a zombie retry of the same offsets from a fresh protocol
    zombie = CommitProtocol(ManifestStore(ns), "A")
    zombie.refresh()
    res, still = zombie.try_commit([_desc("A", 0), _desc("A", 1)])
    assert res.success  # trivial: nothing left after dedup
    view = ms.load_view(ms.latest_version())
    assert len(view.tgbs) == 2


def test_concurrent_producers_linearize(ns):
    """Threads race on conditional puts: the version sequence must be dense,
    and every written TGB appears exactly once in the final list."""
    n_producers, n_each = 6, 8
    threads = []

    def run(pid):
        p = Producer(ns, f"p{pid}", dp=1, cp=1,
                     manifests=ManifestStore(ns))
        for _ in range(n_each):
            p.write_tgb(uniform_slice_bytes=16)
            p.maybe_commit(force=True)
        p.finalize()

    for i in range(n_producers):
        t = threading.Thread(target=run, args=(i,))
        threads.append(t)
        t.start()
    for t in threads:
        t.join()

    ms = ManifestStore(ns)
    latest = ms.latest_version()
    # dense version sequence
    for v in range(latest + 1):
        assert ms.version_exists(v)
    view = ms.load_view(latest)
    ids = [(t.producer_id, t.producer_seq) for t in view.tgbs]
    assert len(ids) == len(set(ids)) == n_producers * n_each
    for i in range(n_producers):
        assert view.producer_offset(f"p{i}") == n_each - 1


def test_trim_advances_base_step(ns):
    ms = ManifestStore(ns)
    p = CommitProtocol(ms, "p0")
    for seq in range(6):
        p.try_commit([_desc("p0", seq)])
    res, _ = p.try_commit([_desc("p0", 6)], trim_to_step=4)
    assert res.success
    view = ms.load_view(ms.latest_version())
    assert view.base_step == 4
    assert view.total_steps == 7
    assert view.tgb_at_step(5).producer_seq == 5
    with pytest.raises(KeyError):
        view.tgb_at_step(3)
