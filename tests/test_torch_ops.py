"""The port's operator CLI and its ``ops.obs`` read surface on the CPU.

Twins of ``tests/test_ops.py``'s data-plane fsck cases (``:26-130``) and
CLI cases (``:190-230``), and of the ``ops.obs`` tests of
``tests/test_obs.py:375-451`` (the dead producer's post-mortem runs its
producer in a subprocess of the port), run against ``repro_torch``; the
inspect and stream cases of ``tests/test_ops.py`` are twinned in
``tests/test_torch_graph.py``. Then across packages: each package's
``main([... "--json", "fsck"])`` and ``main([... "--json", "inspect"])``
over a ``FileObjectStore`` run the other package wrote give equal
documents, but for the composite-cursor departure of ROADMAP Queue 3; and
``obs_summary`` with its clock pinned gives one summary of either
package's snapshots.
"""
import importlib
import io
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro_torch.core import (FileObjectStore, ManifestStore,  # noqa: E402
                              MemoryObjectStore, Namespace, Producer,
                              Reclaimer, Watermark, write_watermark)
from repro_torch.obs.recorder import FlightRecorder  # noqa: E402
from repro_torch.obs.registry import (COUNTER, GAUGE,  # noqa: E402
                                      HISTOGRAM, MetricsRegistry, StatsView,
                                      set_default_registry)
from repro_torch.ops import fsck, main  # noqa: E402
from repro_torch.ops.obs import (component_summary,  # noqa: E402
                                 obs_summary, render_top)


@pytest.fixture
def ns():
    """The port's namespace (shadows the reference's in conftest)."""
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


def _publish(ns, n=5, pid="P", manifests=None, slice_bytes=64):
    p = Producer(ns, pid, dp=1, cp=1,
                 manifests=manifests or ManifestStore(ns))
    for _ in range(n):
        p.write_tgb(uniform_slice_bytes=slice_bytes)
        p.maybe_commit(force=True)
    p.finalize()
    return p


# ---------------------------------------------------------------------------
# fsck: twins of tests/test_ops.py:26-130
# ---------------------------------------------------------------------------

def test_fsck_clean_on_healthy_run(ns):
    _publish(ns, 5)
    report = fsck(ns)
    assert report.clean, report.summary()
    assert report.checked_manifests == 5
    assert report.checked_tgbs == 5
    assert not report.orphans and not report.pending


def test_fsck_detects_deliberate_orphan_and_repairs(ns):
    _publish(ns, 5)
    # a crashed incarnation's superseded object: committed offset is 4, so an
    # unreferenced object at offset 2 is a safe orphan
    orphan_key = ns.tgb_key("P", 2, "deadbeef")
    ns.store.put(orphan_key, b"leftover")
    report = fsck(ns)
    assert not report.clean
    assert report.orphans == [orphan_key]
    assert any(i.kind == "orphan-tgb" for i in report.issues)
    repaired = fsck(ns, repair=True)
    assert repaired.repaired == [orphan_key]
    assert not ns.store.exists(orphan_key)
    assert fsck(ns).clean


def test_fsck_keeps_hands_off_pending_tgbs(ns):
    _publish(ns, 3)
    # offset 10 > committed 2: could be a live producer's pending TGB
    pending_key = ns.tgb_key("P", 10, "cafecafe")
    ns.store.put(pending_key, b"inflight")
    report = fsck(ns, repair=True)
    assert report.pending == [pending_key]
    assert ns.store.exists(pending_key)  # never repaired
    assert not report.orphans
    # pending-only namespaces stay clean: mid-run states are not errors
    assert report.clean


def test_fsck_detects_missing_tgb_as_torn_commit(ns):
    _publish(ns, 4)
    view = ManifestStore(ns).load_view(ManifestStore(ns).latest_version())
    ns.store.delete(view.tgbs[1].object_key)
    report = fsck(ns)
    assert not report.clean
    assert any(i.kind == "missing-tgb" for i in report.issues)


def test_fsck_accepts_reclaimed_tgbs_below_trim(ns):
    _publish(ns, 6)
    write_watermark(ns, 0, Watermark(version=6, step=4))
    Reclaimer(ns, expected_ranks=1).run_cycle()
    # objects below the trim marker are gone but still listed: that is the
    # legitimate post-reclaim state, not a torn commit
    report = fsck(ns)
    assert report.clean, report.summary()


def test_fsck_detects_tgb_size_mismatch(ns):
    _publish(ns, 3)
    view = ManifestStore(ns).load_view(ManifestStore(ns).latest_version())
    ns.store.put(view.tgbs[0].object_key, b"short")
    report = fsck(ns)
    assert any(i.kind == "tgb-size-mismatch" for i in report.issues)
    assert not report.clean


def test_fsck_detects_torn_flat_chain(ns):
    _publish(ns, 5)
    ns.store.delete(ns.manifest_key(3))  # mid-chain gap: never legitimate
    report = fsck(ns)
    assert any(i.kind == "torn-manifest-chain" for i in report.issues)
    assert not report.clean


def test_fsck_detects_torn_delta_chain(ns):
    manifests = ManifestStore(ns, fmt="delta", snapshot_every=100)
    _publish(ns, 6, manifests=manifests)
    # delete an intermediate delta: v6 can no longer rebuild through v3
    ns.store.delete(ns.manifest_key(3))
    report = fsck(ns)
    assert any(i.kind == "torn-manifest-chain" for i in report.issues)
    assert not report.clean


def test_fsck_detects_trim_skew(ns):
    _publish(ns, 6)
    write_watermark(ns, 0, Watermark(version=6, step=3))
    # corrupt operation: trim marker advanced past the lowest watermark
    from repro_torch.core import _msgpack as msgpack
    ns.store.put(ns.trim_key(),
                 msgpack.packb({"safe_step": 5, "safe_version": 2}))
    report = fsck(ns)
    assert any(i.kind == "trim-skew" for i in report.issues)
    assert not report.clean


def test_fsck_detects_unrestorable_watermark(ns):
    _publish(ns, 6)
    # rank 0 checkpointed at v2, but the retained prefix now starts at v3
    write_watermark(ns, 0, Watermark(version=2, step=1))
    for v in (0, 1, 2):
        ns.store.delete(ns.manifest_key(v))
    report = fsck(ns)
    assert any(i.kind == "watermark-unreadable" for i in report.issues)


# ---------------------------------------------------------------------------
# CLI: twins of tests/test_ops.py:180-230 (exit codes are the contract)
# ---------------------------------------------------------------------------

@pytest.fixture
def file_run(tmp_path):
    store = FileObjectStore(str(tmp_path / "store"))
    ns = Namespace(store, "runs/job")
    _publish(ns, 4)
    return tmp_path / "store", ns


def test_cli_inspect_and_fsck_clean(file_run, capsys):
    root, _ns = file_run
    assert main(["--root", str(root), "-n", "runs/job", "inspect"]) == 0
    assert "total_steps=4" in capsys.readouterr().out
    assert main(["--root", str(root), "-n", "runs/job", "fsck"]) == 0
    assert "clean" in capsys.readouterr().out


def test_cli_fsck_finds_and_repairs_orphan(file_run, capsys):
    root, ns = file_run
    ns.store.put(ns.tgb_key("P", 1, "deadbeef"), b"junk")
    assert main(["--root", str(root), "-n", "runs/job", "fsck"]) == 1
    assert "orphan-tgb" in capsys.readouterr().out
    assert main(["--root", str(root), "-n", "runs/job", "fsck",
                 "--repair"]) == 1  # reports the state it found, then fixes
    capsys.readouterr()
    assert main(["--root", str(root), "-n", "runs/job", "fsck"]) == 0


def test_cli_fsck_json_output(file_run, capsys):
    import json

    root, _ns = file_run
    assert main(["--root", str(root), "-n", "runs/job", "--json",
                 "fsck"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["clean"] is True
    assert doc["checked_tgbs"] == 4


def test_cli_trim(file_run, capsys):
    root, ns = file_run
    write_watermark(ns, 0, Watermark(version=3, step=2))
    out = io.StringIO()
    assert main(["--root", str(root), "-n", "runs/job", "trim",
                 "--ranks", "1"], out=out) == 0
    assert "safe_step=2" in out.getvalue()
    assert len(ns.store.list(ns.key("tgb"))) == 2  # steps 0,1 reclaimed
    assert main(["--root", str(root), "-n", "runs/job", "fsck"]) == 0


# ---------------------------------------------------------------------------
# the obs/top read surface: twins of tests/test_obs.py:370-478
# ---------------------------------------------------------------------------

class CStats(StatsView):
    _FAMILY = "consumer"
    _SPEC = {"steps_consumed": COUNTER, "bytes_consumed": COUNTER}


def test_component_summary_rates_and_lag(ns):
    reg = MetricsRegistry()
    v = CStats("d0c0", registry=reg)
    rec = FlightRecorder(ns, v.metric_scope, interval_s=0.0, registry=reg)
    v.steps_consumed, v.bytes_consumed = 2, 2048
    assert rec.snap()
    time.sleep(0.01)
    v.steps_consumed, v.bytes_consumed = 3, 3072
    assert rec.snap()
    row = component_summary(ns, "consumer.d0c0",
                            frontier={"version": 4, "total_steps": 10})
    assert row["family"] == "consumer" and row["snaps"] == 2
    assert row["metrics"]["steps_consumed"] == 3
    assert row["lag_steps"] == 7
    assert row["steps_per_s"] == pytest.approx(
        row["rates"]["steps_consumed_per_s"])
    assert row["steps_per_s"] > 0
    assert row["throughput_Bps"] == pytest.approx(
        row["rates"]["bytes_consumed_per_s"])


def test_rates_never_cross_incarnations(ns):
    reg = MetricsRegistry()
    v = CStats("d0c0", registry=reg)
    r1 = FlightRecorder(ns, v.metric_scope, interval_s=0.0, registry=reg)
    v.steps_consumed = 5
    assert r1.snap()
    # restart: the counter resets in a new incarnation; differencing across
    # the restart would yield a negative rate
    reg2 = MetricsRegistry()
    v2 = CStats("d0c0", registry=reg2)
    r2 = FlightRecorder(ns, v2.metric_scope, interval_s=0.0, registry=reg2)
    v2.steps_consumed = 1
    assert r2.snap()
    row = component_summary(ns, "consumer.d0c0")
    assert row["rates"] == {}  # only one snapshot of the latest incarnation


def test_obs_summary_empty_namespace(ns):
    s = obs_summary(ns)
    assert s["frontier"] is None and s["components"] == []
    buf = io.StringIO()
    render_top(s, buf)
    assert "no telemetry snapshots" in buf.getvalue()


def test_obs_summary_recurses_streams(ns, reg):
    v, rec = _recorder(ns, reg, instance="root")
    assert rec.snap()
    sns = ns.stream("filtered")
    v2 = VStats("sub", registry=reg)
    rec2 = FlightRecorder(sns, v2.metric_scope, interval_s=0.0, registry=reg)
    assert rec2.snap()
    s = obs_summary(ns)
    assert [c["component"] for c in s["components"]] == ["vtest.root"]
    assert [c["component"] for c in s["streams"]["filtered"]["components"]] \
        == ["vtest.sub"]


# ---------------------------------------------------------------------------
# post-mortem: a dead producer renders from storage alone
# ---------------------------------------------------------------------------

_PRODUCER_SCRIPT = """
import os
from repro_torch.core import FileObjectStore, Namespace, Producer
ns = Namespace(FileObjectStore({root!r}), "runs/pm")
p = Producer(ns, "p0", dp=1, cp=1, obs_snap_interval_s=0.0)
p.recover()
for i in range(5):
    p.write_tgb(slice_payloads={{(0, 0): bytes([i]) * 64}})
    p.maybe_commit(force=True)
os._exit(0)  # hard exit: no finalize, no close, no goodbye snapshot
"""


def test_top_renders_dead_producer(tmp_path):
    """The acceptance demo: the producing process is *gone* (hard-exited in
    a subprocess) and ``batchweave top``/``obs --json`` still reconstruct
    its counters purely from object-store snapshots."""
    root = str(tmp_path / "store")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(repro_torch.__file__))
    proc = subprocess.run(
        [sys.executable, "-c", _PRODUCER_SCRIPT.format(root=root)],
        env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr

    from repro_torch.ops.cli import main as ops_main
    buf = io.StringIO()
    assert ops_main(["--root", root, "-n", "runs/pm", "top"], out=buf) == 0
    top = buf.getvalue()
    assert "producer.p0" in top and "total_steps=5" in top

    buf = io.StringIO()  # NB: the global --json flag precedes the subcommand
    assert ops_main(["--root", root, "-n", "runs/pm", "--json", "obs"],
                    out=buf) == 0
    doc = json.loads(buf.getvalue())
    rows = {r["component"]: r for r in doc["components"]}
    row = rows["producer.p0"]
    assert row["metrics"]["tgbs_written"] == 5
    assert row["metrics"]["commit_successes"] >= 4
    assert row["conflict_rate"] == 0.0
    assert doc["frontier"]["total_steps"] == 5


# ---------------------------------------------------------------------------
# across packages
# ---------------------------------------------------------------------------

MIX_NS = "runs/mix"


def _pkg(name):
    """(core, dataplane, run, ops) of one package."""
    pytest.importorskip("msgpack")
    return tuple(importlib.import_module(f"{name}.{m}")
                 for m in ("core", "dataplane", "run", "ops"))


def _mixed_file_run(writer, root):
    """``writer``'s TrainSession over a FileObjectStore at ``root``: a flat
    ``web`` stream and a 2-shard ``code`` stream mixed 1:1, 4 steps, an
    aligned (composite) checkpoint, a reclaim, then a crashed incarnation's
    orphan TGB planted in ``web``."""
    core, dp, run, _ = _pkg(writer)
    store = core.FileObjectStore(root)
    ns = core.Namespace(store, MIX_NS)
    for name, shards in (("web", None), ("code", 2)):
        sns = ns.stream(name)
        kw = {"manifests": core.open_manifest_store(sns, shards=shards)} \
            if shards else {}
        p = core.Producer(sns, name.upper(), dp=2, cp=1, **kw)
        p.recover()
        for _ in range(6):
            p.write_tgb(uniform_slice_bytes=64)
            p.maybe_commit(force=True)
        p.finalize()
    sess = run.TrainSession(store, dp.Topology(dp=2, cp=1, global_batch=4,
                                                seq_len=8),
                            namespace=MIX_NS,
                            streams={"web": 0.5, "code": 0.5}, mix_seed=1)
    readers = [sess.reader(dp_rank=d) for d in range(2)]
    for _ in range(4):
        for r in readers:
            r.next_batch(timeout_s=5)
    sess.checkpoint({"w": np.ones(3, np.float32)})
    sess.reclaim()
    sess.close()
    store.put(ns.stream("web").tgb_key("WEB", 1, "deadbeef"), b"junk")


def _cli_doc(reader, root, *args):
    """(exit code, JSON document) of ``reader``'s CLI over ``root``."""
    ops = _pkg(reader)[3]
    buf = io.StringIO()
    rc = ops.main(["--root", str(root), "-n", MIX_NS, "--json", *args],
                  out=buf)
    return rc, json.loads(buf.getvalue())


@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
@pytest.mark.parametrize("cmd", ["fsck", "inspect"])
def test_either_cli_reads_a_run_the_other_wrote(tmp_path, writer, cmd):
    """Both packages' CLIs over one run give one document and exit code.
    The one difference is ROADMAP Queue 3's departure: the reference reads
    the composite cursor of the sharded ``code`` stream against flat
    manifest versions, finds none and adds a ``runmanifest-unreadable-
    cursor`` error the port does not."""
    root = tmp_path / "store"
    _mixed_file_run(writer, str(root))
    t_rc, t_doc = _cli_doc("repro_torch", root, cmd)
    j_rc, j_doc = _cli_doc("repro", root, cmd)
    assert t_rc == j_rc == (1 if cmd == "fsck" else 0)
    if cmd == "inspect":
        assert t_doc == j_doc
        assert t_doc["runmanifest"]["aligned"]["streams"]["code"]
        return
    departure = [i for i in j_doc["issues"]
                 if i["kind"] == "runmanifest-unreadable-cursor"]
    assert len(departure) == 1 and "'code'" in departure[0]["detail"]
    j_doc["issues"].remove(departure[0])
    assert t_doc == j_doc
    orphans = t_doc["streams"]["web"]["orphans"]
    assert t_doc["clean"] is False and len(orphans) == 1
    assert orphans[0].endswith("deadbeef.tgb")


@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
def test_obs_summary_is_equal_across_packages(tmp_path, writer):
    """A producer and a consumer of ``writer`` publish flight-recorder
    snapshots; with the clock pinned, both packages' ``obs_summary`` give
    one summary of them."""
    core = _pkg(writer)[0]
    registry = importlib.import_module(f"{writer}.obs.registry")
    prev = registry.set_default_registry(registry.MetricsRegistry())
    try:
        ns = core.Namespace(core.FileObjectStore(str(tmp_path)), "runs/pm")
        p = core.Producer(ns, "p0", dp=1, cp=1, obs_snap_interval_s=0.0)
        p.recover()
        for i in range(4):
            p.write_tgb(slice_payloads={(0, 0): bytes([i]) * 32})
            p.maybe_commit(force=True)
        p.finalize()
        c = core.Consumer(ns, core.MeshPosition(0, 0, 1, 1),
                          obs_snap_interval_s=0.0)
        for _ in range(3):
            c.next_batch(timeout_s=5.0)
    finally:
        registry.set_default_registry(prev)
    t_now = time.time() + 5.0
    docs = []
    for reader in ("repro", "repro_torch"):
        rcore, ops_obs = _pkg(reader)[0], importlib.import_module(
            f"{reader}.ops.obs")
        docs.append(ops_obs.obs_summary(
            rcore.Namespace(rcore.FileObjectStore(str(tmp_path)), "runs/pm"),
            now=t_now))
    assert docs[0] == docs[1]
    rows = {r["component"]: r for r in docs[1]["components"]}
    assert rows["producer.p0"]["metrics"]["tgbs_written"] == 4
    assert rows["consumer.d0c0"]["lag_steps"] == 1
    assert all(r["age_s"] > 0 for r in rows.values())
