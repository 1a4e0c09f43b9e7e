"""Twin of ``tests/test_objectstore.py`` on the port: object store semantics
(conditional put, range reads, faults, the memory and file backends) of
``repro_torch.core``. Imports neither jax nor msgpack.
"""
import threading

import pytest

pytest.importorskip("torch")

from repro_torch.core import (FaultInjector, FileObjectStore,  # noqa: E402
                              InjectedCrash, LatencyModel, MemoryObjectStore,
                              Namespace, NoSuchKey, VirtualClock)


@pytest.fixture(params=["memory", "file"])
def any_store(request, tmp_path):
    if request.param == "memory":
        return MemoryObjectStore()
    return FileObjectStore(str(tmp_path / "store"))


def test_put_get_roundtrip(any_store):
    any_store.put("a/b/c", b"hello")
    assert any_store.get("a/b/c") == b"hello"
    assert any_store.head("a/b/c") == 5
    with pytest.raises(NoSuchKey):
        any_store.get("a/b/missing")


def test_conditional_put_is_exclusive(any_store):
    assert any_store.put_if_absent("k", b"first")
    assert not any_store.put_if_absent("k", b"second")
    assert any_store.get("k") == b"first"
    assert any_store.stats.conditional_put_conflicts == 1


def test_conditional_put_race_single_winner(any_store):
    winners = []
    barrier = threading.Barrier(8)

    def attempt(i):
        barrier.wait()
        if any_store.put_if_absent("contested", f"w{i}".encode()):
            winners.append(i)

    threads = [threading.Thread(target=attempt, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(winners) == 1
    assert any_store.get("contested") == f"w{winners[0]}".encode()


def test_range_get(any_store):
    any_store.put("r", bytes(range(100)))
    assert any_store.get_range("r", 10, 5) == bytes(range(10, 15))
    assert any_store.get_range("r", 95, 100) == bytes(range(95, 100))


def test_list_prefix_and_delete(any_store):
    for k in ("p/1", "p/2", "q/3"):
        any_store.put(k, b"x")
    assert any_store.list("p/") == ["p/1", "p/2"]
    any_store.delete("p/1")
    any_store.delete("p/1")  # idempotent
    assert any_store.list("p/") == ["p/2"]


def test_total_bytes_tracks_deletes(any_store):
    any_store.put("a", b"x" * 100)
    any_store.put("b", b"y" * 50)
    assert any_store.total_bytes() == 150
    any_store.delete("a")
    assert any_store.total_bytes() == 50


def test_overwrite_put(any_store):
    any_store.put("k", b"v1")
    any_store.put("k", b"v2-longer")
    assert any_store.get("k") == b"v2-longer"


def test_latency_model_advances_virtual_clock():
    clock = VirtualClock()
    lat = LatencyModel(put_base_s=0.01, put_bw_Bps=1e6, jitter_frac=0.0)
    s = MemoryObjectStore(latency=lat, clock=clock)
    s.put("k", b"x" * 1_000_000)
    assert abs(clock.now() - (0.01 + 1.0)) < 1e-6


def test_fault_injection_crash():
    faults = FaultInjector()
    faults.crash_on("put", key_substr="manifest", nth=2)
    s = MemoryObjectStore(faults=faults)
    s.put("a/manifest/1", b"x")
    with pytest.raises(InjectedCrash):
        s.put("a/manifest/2", b"x")
    assert not s.exists("a/manifest/2")  # crash was before the write


def test_namespace_keys():
    ns = Namespace(MemoryObjectStore(), "runs/exp1")
    assert ns.manifest_key(11) == "runs/exp1/manifest/00000011.manifest"
    assert ns.tgb_key("p0", 5, "ab").startswith("runs/exp1/tgb/p0/000000000005-")
    assert "rank00003" in ns.watermark_key(3)


def test_conditional_put_never_exposes_partial_object(tmp_path):
    """A losing or in-flight conditional put must never make a truncated
    object visible: the key is claimed via an atomic link of a fully-written
    temp file, so any reader that sees the key sees the whole payload."""
    import os

    store = FileObjectStore(str(tmp_path / "atomic"))
    payload = b"z" * 1_000_000
    stop = threading.Event()
    partials = []

    def watcher():
        while not stop.is_set():
            try:
                n = store.head("claimed")
            except NoSuchKey:
                continue
            if n != len(payload):
                partials.append(n)

    t = threading.Thread(target=watcher, daemon=True)
    t.start()
    for i in range(20):
        assert store.put_if_absent("claimed", payload)
        assert not store.put_if_absent("claimed", b"short loser")
        assert store.get("claimed") == payload
        store.delete("claimed")
    stop.set()
    t.join(timeout=5)
    assert partials == []
    # losers leave no temp-file litter behind
    leftovers = [fn for _, _, fns in os.walk(store.root)
                 for fn in fns if ".tmp." in fn]
    assert leftovers == []


def test_namespace_stream_scoping():
    ns = Namespace(MemoryObjectStore(), "runs/exp1")
    web = ns.stream("web")
    assert web.manifest_key(3) == "runs/exp1/streams/web/manifest/00000003.manifest"
    assert web.trim_key().startswith("runs/exp1/streams/web/")
    with pytest.raises(ValueError):
        ns.stream("")
    with pytest.raises(ValueError):
        ns.stream("..")
