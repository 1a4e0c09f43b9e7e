"""The port's flight recorder (``repro_torch.obs.recorder``) on the CPU.

Twins of the recorder tests of ``tests/test_obs.py`` (``:241-355`` and the
live producer/consumer case at ``:481``) run against the port; then across
packages: for the same registry contents, incarnation token and clocks,
either package's ``FlightRecorder`` writes byte-identical snapshots, and
each package's ``read_snapshots`` reads the other's chain.
"""
import json
import types

import pytest

pytest.importorskip("torch")

from repro_torch.core import (Consumer, FaultPolicy,  # noqa: E402
                              FaultyObjectStore, MemoryObjectStore,
                              MeshPosition, Namespace, Producer, Reclaimer,
                              Watermark, write_watermark)
from repro_torch.obs import recorder as trec  # noqa: E402
from repro_torch.obs.recorder import (FlightRecorder,  # noqa: E402
                                      _snap_key, component_dirs,
                                      latest_snapshot, list_snaps,
                                      prune_snaps, read_snapshots)
from repro_torch.obs.registry import (COUNTER, GAUGE,  # noqa: E402
                                      HISTOGRAM, MetricsRegistry, StatsView,
                                      set_default_registry)


@pytest.fixture
def tns():
    return Namespace(MemoryObjectStore(), "runs/test")


@pytest.fixture
def reg():
    """Isolate the port's default registry per test and restore it after."""
    fresh = MetricsRegistry()
    prev = set_default_registry(fresh)
    yield fresh
    set_default_registry(prev)


class VStats(StatsView):
    _FAMILY = "vtest"
    _SPEC = {"n": COUNTER, "level": GAUGE, "lat": HISTOGRAM}


def _recorder(ns, reg, instance="a", **kw):
    v = VStats(instance, registry=reg)
    rec = FlightRecorder(ns, v.metric_scope, interval_s=0.0, registry=reg,
                         **kw)
    return v, rec


# ---------------------------------------------------------------------------
# twins of tests/test_obs.py:241-355
# ---------------------------------------------------------------------------

def test_snap_chain_and_latest(tns):
    reg = MetricsRegistry()
    v, rec = _recorder(tns, reg)
    v.n += 1
    assert rec.snap()
    v.n += 4
    assert rec.snap()
    assert list_snaps(tns, "vtest.a") == [0, 1]
    snaps = read_snapshots(tns, "vtest.a")
    assert [s["seq"] for s in snaps] == [0, 1]
    assert snaps[0]["metrics"]["vtest.a.n"] == 1
    last = latest_snapshot(tns, "vtest.a")
    assert last["seq"] == 1 and last["metrics"]["vtest.a.n"] == 5
    assert last["inc"] == snaps[0]["inc"]
    assert component_dirs(tns) == ["vtest.a"]


def test_maybe_snap_interval_gating(tns):
    reg = MetricsRegistry()
    _, rec = _recorder(tns, reg)
    rec.interval_s = 3600.0
    assert rec.maybe_snap() is True    # first heartbeat always publishes
    assert rec.maybe_snap() is False   # interval not elapsed
    assert rec.published == 1
    assert rec.close()                 # shutdown forces a final snapshot
    assert list_snaps(tns, "vtest.a") == [0, 1]


def test_recorder_rejects_bad_component():
    with pytest.raises(ValueError):
        FlightRecorder(Namespace(MemoryObjectStore(), "r"), "a/b")
    with pytest.raises(ValueError):
        FlightRecorder(Namespace(MemoryObjectStore(), "r"), "")


def test_snap_never_raises_under_faults():
    inner = MemoryObjectStore()
    store = FaultyObjectStore(inner, FaultPolicy(
        seed=3, cput_error_rate=1.0, cput_lost_ack_rate=0.0,
        key_filter=".snap", max_faults=3))
    ns = Namespace(store, "runs/test")
    reg = MetricsRegistry()
    v, rec = _recorder(ns, reg)
    v.n += 1
    assert rec.snap() is False         # injected cput error, swallowed
    assert rec.dropped >= 1
    for _ in range(10):                # burn through max_faults, then land
        if rec.snap():
            break
    assert rec.published >= 1
    snaps = read_snapshots(ns, rec.component)
    assert snaps and snaps[-1]["metrics"][f"{rec.component}.n"] == 1


def test_snap_survives_lost_ack():
    inner = MemoryObjectStore()
    store = FaultyObjectStore(inner, FaultPolicy(
        seed=0, cput_error_rate=1.0, cput_lost_ack_rate=1.0,
        key_filter=".snap", max_faults=1))
    ns = Namespace(store, "runs/test")
    reg = MetricsRegistry()
    v, rec = _recorder(ns, reg)
    assert rec.snap() is False and rec.dropped == 1
    assert rec.snap() is True
    seqs = list_snaps(ns, rec.component)
    assert seqs == sorted(set(seqs))   # no overwrites, chain intact
    assert len(read_snapshots(ns, rec.component)) == len(seqs)


def test_torn_snapshot_skipped(tns):
    reg = MetricsRegistry()
    v, rec = _recorder(tns, reg)
    assert rec.snap()
    tns.store.put(_snap_key(tns, rec.component, 1), b"{torn")
    rec._next_seq = None               # recorder re-lists past the garbage
    v.n += 1
    assert rec.snap()
    snaps = read_snapshots(tns, rec.component)
    assert [s["seq"] for s in snaps] == [0, 2]
    tns.store.put(_snap_key(tns, rec.component, 3),
                  json.dumps({"schema": 99, "seq": 3}).encode())
    assert [s["seq"] for s in read_snapshots(tns, rec.component)] == [0, 2]


def test_two_incarnations_interleave(tns):
    reg = MetricsRegistry()
    v = VStats("a", registry=reg)
    r1 = FlightRecorder(tns, v.metric_scope, interval_s=0.0, registry=reg)
    r2 = FlightRecorder(tns, v.metric_scope, interval_s=0.0, registry=reg)
    assert r1.incarnation != r2.incarnation
    assert r1.snap() and r2.snap() and r1.snap()
    snaps = read_snapshots(tns, v.metric_scope)
    assert [s["seq"] for s in snaps] == [0, 1, 2]
    assert [s["inc"] for s in snaps] == \
        [r1.incarnation, r2.incarnation, r1.incarnation]


def test_prune_snaps_keeps_newest(tns):
    reg = MetricsRegistry()
    v, rec = _recorder(tns, reg)
    for i in range(12):
        v.n += 1
        assert rec.snap()
    assert prune_snaps(tns, keep=8) == 4
    assert list_snaps(tns, rec.component) == list(range(4, 12))
    assert latest_snapshot(tns, rec.component)["metrics"][
        f"{rec.component}.n"] == 12


def test_reclaimer_prunes_obs_snaps(tns, reg):
    v, rec = _recorder(tns, reg)
    for _ in range(6):
        assert rec.snap()
    write_watermark(tns, 0, Watermark(version=0, step=0))
    r = Reclaimer(tns, expected_ranks=1, obs_keep_snaps=2)
    assert r.run_cycle() is not None
    assert r.stats.obs_snaps_deleted == 4
    assert list_snaps(tns, rec.component) == [4, 5]


def test_live_producer_consumer_snapshots(tns, reg):
    """Twin of ``tests/test_obs.py:481``: producer and consumer publish
    through their natural heartbeats (read here from the snapshots; the
    reference reads them through ``ops.obs``, ROADMAP Queue 1 item 9)."""
    p = Producer(tns, "p0", dp=1, cp=1, obs_snap_interval_s=0.0)
    p.recover()
    for i in range(4):
        p.write_tgb(slice_payloads={(0, 0): bytes([i]) * 32})
        p.maybe_commit(force=True)
    p.finalize()
    c = Consumer(tns, MeshPosition(0, 0, 1, 1), obs_snap_interval_s=0.0)
    for _ in range(3):
        c.next_batch(timeout_s=5.0)
    assert component_dirs(tns) == ["consumer.d0c0", "producer.p0"]
    prod = latest_snapshot(tns, "producer.p0")["metrics"]
    cons = latest_snapshot(tns, "consumer.d0c0")["metrics"]
    assert prod["producer.p0.tgbs_written"] == 4
    assert prod["producer.p0.commit_successes"] >= 4
    assert cons["consumer.d0c0.steps_consumed"] == 3
    # the producer's last-word snapshot is its final state
    assert prod == reg.snapshot("producer.p0.")


def test_session_options_reach_every_client(reg):
    """``obs_snap_interval_s`` on a tgb session: its writer's producer and
    its readers' consumers publish, and the snapshot equals the live
    registry's slice."""
    import numpy as np

    from repro_torch.dataplane import Topology, open_dataplane
    store = MemoryObjectStore()
    topo = Topology(dp=2, cp=1, global_batch=2, seq_len=8)
    sess = open_dataplane(store, topo, namespace="runs/obs",
                          obs_snap_interval_s=0.0)
    with sess.writer("w0") as w:
        w.write_tokens(np.arange(3 * 16, dtype=np.int32))
    r = sess.reader(dp_rank=1)
    for _ in range(3):
        r.next_batch(timeout_s=5)
    ns = Namespace(store, "runs/obs")
    assert set(component_dirs(ns)) == {"producer.w0", "consumer.d1c0"}
    assert latest_snapshot(ns, "producer.w0")["metrics"] == \
        reg.snapshot("producer.w0.")
    assert latest_snapshot(ns, "consumer.d1c0")["metrics"][
        "consumer.d1c0.steps_consumed"] == 3
    sess.close()


# ---------------------------------------------------------------------------
# across packages
# ---------------------------------------------------------------------------

def _frozen(monkeypatch, module, t, wall):
    monkeypatch.setattr(module, "time", types.SimpleNamespace(
        monotonic=lambda: t, time=lambda: wall))


def _chain(pkg, monkeypatch, n_snaps=3):
    """Three snapshots of one component whose counter, gauge and histogram
    hold the same values in either package, at frozen clocks and a fixed
    incarnation: (namespace, [raw snapshot bytes])."""
    if pkg == "repro":
        from repro.core import MemoryObjectStore as Store
        from repro.core import Namespace as Ns
        from repro.obs import recorder as mod
        from repro.obs.registry import COUNTER as C, GAUGE as G
        from repro.obs.registry import HISTOGRAM as H
        from repro.obs.registry import MetricsRegistry as Reg
        from repro.obs.registry import StatsView as View
    else:
        Store, Ns, mod, C, G, H = (MemoryObjectStore, Namespace, trec,
                                   COUNTER, GAUGE, HISTOGRAM)
        Reg, View = MetricsRegistry, StatsView

    class Stats(View):
        _FAMILY = "vtest"
        _SPEC = {"n": C, "level": G, "lat": H}

    _frozen(monkeypatch, mod, 12.345, 1754700000.25)
    reg = Reg()
    v = Stats("x", registry=reg)
    ns = Ns(Store(), "runs/xframe")
    rec = mod.FlightRecorder(ns, v.metric_scope, interval_s=0.0, registry=reg)
    rec.incarnation = "a1b2c3d4"
    raw = []
    for i in range(n_snaps):
        v.n += i + 1
        v.level = 0.5 * i
        for x in (0.001 * i, 0.02, 0.3 + i):
            v.lat.append(x)
        assert rec.snap()
        raw.append(ns.store.get(mod._snap_key(ns, v.metric_scope, i)))
    return ns, raw


def test_snapshots_are_byte_identical_across_packages(monkeypatch):
    pytest.importorskip("jax")
    _, jraw = _chain("repro", monkeypatch)
    _, traw = _chain("repro_torch", monkeypatch)
    assert traw == jraw
    doc = json.loads(traw[-1])
    assert (doc["seq"], doc["inc"], doc["metrics"]["vtest.x.n"]) == \
        (2, "a1b2c3d4", 6)


@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
def test_each_package_reads_the_others_snapshots(monkeypatch, writer):
    pytest.importorskip("jax")
    from repro.core import MemoryObjectStore as JStore
    from repro.core import Namespace as JNs
    from repro.obs import recorder as jrec
    ns, _ = _chain(writer, monkeypatch)
    views = {"repro": (JStore, JNs, jrec),
             "repro_torch": (MemoryObjectStore, Namespace, trec)}
    docs = []
    for Store, Ns, mod in views.values():
        store = Store()
        store._objects, store._lock = ns.store._objects, ns.store._lock
        view = Ns(store, "runs/xframe")
        assert mod.component_dirs(view) == ["vtest.x"]
        docs.append(mod.read_snapshots(view, "vtest.x"))
        assert mod.latest_snapshot(view, "vtest.x") == docs[-1][-1]
    assert docs[0] == docs[1] and [d["seq"] for d in docs[0]] == [0, 1, 2]
