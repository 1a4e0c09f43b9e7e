"""The port's RunManifest, TrainSession, model checkpoints and fsck
(``repro_torch.run``, ``repro_torch.train.checkpoint``,
``repro_torch.ops``) on the CPU.

Twins of ``tests/test_run.py`` (all of it: the record/store layer, the
TrainSession save/resume round trip, exactly-once recovery from a kill
between model upload and RunManifest commit, RunManifest-bounded
reclamation and the fsck audits of the aligned chain), of the TrainSession
and fsck tests of ``tests/test_elastic.py`` (factor DP resizes) and of the
checkpoint tests of ``tests/test_train.py``; then the port's own rules:
tensor leaves land on their template leaf's device with the recorded dtype,
and bf16 needs no ``ml_dtypes``. msgpack documents are written with the
port's codec. The multi-stream and derived-stream twins are in
``tests/test_torch_streams.py`` and ``tests/test_torch_graph.py``.
"""
import base64

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import (InjectedCrash, FaultInjector,  # noqa: E402
                              MemoryObjectStore, Namespace, Watermark,
                              convert_logical_step, read_trim_marker,
                              read_watermarks, write_watermark)
from repro_torch.core import _msgpack as msgpack  # noqa: E402
from repro_torch.dataplane import Checkpoint, Topology  # noqa: E402
from repro_torch.dataplane.types import UnsupportedOperation  # noqa: E402
from repro_torch.ops import fsck  # noqa: E402
from repro_torch.run import (RunManifest, RunManifestError,  # noqa: E402
                             RunManifestStore, TrainSession)
from repro_torch.train.checkpoint import (list_checkpoints,  # noqa: E402
                                          load_model_state,
                                          restore_checkpoint,
                                          save_checkpoint,
                                          upload_model_state)

NS = "runs/test_run"


def _fill(session: TrainSession, n: int, nbytes: int = 256) -> None:
    with session.writer("P") as w:
        for _ in range(n):
            w.write(uniform_slice_bytes=nbytes)
        w.flush()


def _drain(readers, n):
    out = []
    for _ in range(n):
        batches = [r.next_batch(timeout_s=10) for r in readers]
        out.append(b"".join(b.payload for b in batches))
    return out


# ---------------------------------------------------------------------------
# RunManifest record + store
# ---------------------------------------------------------------------------

def test_runmanifest_roundtrip_and_schema_guard():
    ck = Checkpoint("tgb", version=3, step=7, topology=(2, 1), data_dp=2)
    rm = RunManifest(seq=2, step=7, model_key="k/MANIFEST.ckpt",
                     data_token=ck.encode(), topology=(2, 1), data_dp=2,
                     global_batch=8, seq_len=64)
    back = RunManifest.unpack(rm.pack())
    assert back == rm
    assert back.data_checkpoint() == ck
    assert back.aligned_data_step() == 7
    with pytest.raises(RunManifestError, match="schema"):
        RunManifest.unpack(msgpack.packb({"schema": 99}))
    with pytest.raises(RunManifestError):
        RunManifest.unpack(b"garbage")


def test_runmanifest_store_sequences_are_claimed_once():
    store = MemoryObjectStore()
    runs = RunManifestStore(Namespace(store, NS))
    assert runs.latest() is None
    ck = Checkpoint("tgb", version=0, step=1, topology=(1, 1), data_dp=1)
    a = runs.append(step=1, model_key="m1", data_token=ck.encode(),
                    topology=(1, 1), data_dp=1)
    b = runs.append(step=2, model_key="m2", data_token=ck.encode(),
                    topology=(1, 1), data_dp=1)
    assert (a.seq, b.seq) == (0, 1)
    assert runs.latest().model_key == "m2"
    # a stale incarnation loses the conditional put for a taken sequence
    stale = RunManifest(seq=1, step=9, model_key="mX",
                        data_token=ck.encode(), topology=(1, 1), data_dp=1)
    assert not runs.commit(stale)
    assert runs.read(1).model_key == "m2"


def test_runmanifest_watermark_derivation():
    single = Checkpoint("tgb", version=5, step=6, topology=(2, 1), data_dp=2)
    rm = RunManifest(seq=0, step=6, model_key="m", data_token=single.encode(),
                     topology=(2, 1), data_dp=2)
    assert rm.watermark() == Watermark(version=5, step=6)
    # captured on a 2x-resized mesh: logical steps convert to tgb units
    grown = Checkpoint("tgb", version=5, step=3, topology=(4, 1), data_dp=2)
    rm2 = RunManifest(seq=1, step=3, model_key="m", data_token=grown.encode(),
                      topology=(4, 1), data_dp=2)
    assert rm2.watermark() == Watermark(version=5, step=6)
    comp = Checkpoint("tgb", version=-1, step=10, mix_pos=10,
                      topology=(1, 1), data_dp=1,
                      streams=(("a", 4, 7), ("b", 2, 3)))
    rm3 = RunManifest(seq=2, step=10, model_key="m", data_token=comp.encode(),
                      topology=(1, 1), data_dp=1)
    assert rm3.watermark("a") == Watermark(version=4, step=7)
    assert rm3.watermark("b") == Watermark(version=2, step=3)
    with pytest.raises(RunManifestError):
        rm3.watermark()  # composite needs a stream name


# ---------------------------------------------------------------------------
# TrainSession: aligned save / resume
# ---------------------------------------------------------------------------

def test_train_session_round_trip_exactly_once():
    store = MemoryObjectStore()
    topo = Topology(dp=2, cp=1)
    sess = TrainSession(store, topo, namespace=NS)
    _fill(sess, 10)
    readers = [sess.reader(dp_rank=d) for d in range(2)]
    _drain(readers, 4)
    entry = sess.checkpoint({"w": np.arange(5, dtype=np.float32)})
    assert (entry.seq, entry.step) == (0, 4)
    tail = _drain(readers, 6)

    resumed = TrainSession.resume(store, NS)
    assert resumed.resume_step == 4
    state = resumed.restore_model({"w": np.zeros(5, np.float32)})
    assert np.array_equal(np.asarray(state["w"]),
                          np.arange(5, dtype=np.float32))
    r2 = [resumed.reader(dp_rank=d) for d in range(2)]
    assert _drain(r2, 6) == tail  # byte-identical replay: exactly-once


def test_train_session_checkpoint_requires_readers_and_lockstep():
    store = MemoryObjectStore()
    sess = TrainSession(store, Topology(dp=2, cp=1), namespace=NS)
    with pytest.raises(RuntimeError, match="readers"):
        sess.checkpoint({"w": np.zeros(1)})
    _fill(sess, 4)
    readers = [sess.reader(dp_rank=d) for d in range(2)]
    readers[0].next_batch(timeout_s=10)  # rank 0 runs ahead
    with pytest.raises(RuntimeError, match="lockstep"):
        sess.checkpoint({"w": np.zeros(1)})


def test_train_session_resume_without_entries_raises():
    with pytest.raises(KeyError, match="no RunManifest"):
        TrainSession.resume(MemoryObjectStore(), NS)


def test_train_session_rejects_non_tgb_backend():
    with pytest.raises(UnsupportedOperation, match="tgb"):
        TrainSession(MemoryObjectStore(), Topology(dp=1, cp=1), backend="mq")


def test_kill_between_upload_and_commit_resumes_aligned():
    store = MemoryObjectStore(faults=FaultInjector())
    sess = TrainSession(store, Topology(dp=1, cp=1), namespace=NS)
    _fill(sess, 8)
    r = sess.reader()
    seen = [r.next_batch(timeout_s=10).payload for _ in range(3)]
    sess.checkpoint({"w": np.float32(1.0)})
    lost = [r.next_batch(timeout_s=10).payload for _ in range(2)]
    store.faults.crash_on("cput", key_substr=".rm", nth=1)
    with pytest.raises(InjectedCrash):
        sess.checkpoint({"w": np.float32(2.0)})
    store.faults = None

    resumed = TrainSession.resume(store, NS)
    assert resumed.resume_step == 3
    state = resumed.restore_model({"w": np.float32(0.0)})
    assert float(np.asarray(state["w"])) == 1.0  # the ALIGNED model
    r2 = resumed.reader()
    replay = [r2.next_batch(timeout_s=10).payload for _ in range(5)]
    assert replay[:2] == lost
    assert seen + replay == seen + lost + replay[2:]


# ---------------------------------------------------------------------------
# Reclamation tied to the aligned checkpoint
# ---------------------------------------------------------------------------

def test_reclaimer_bounded_by_runmanifest_not_rank_files():
    store = MemoryObjectStore()
    topo = Topology(dp=1, cp=1)
    sess = TrainSession(store, topo, namespace=NS)
    _fill(sess, 10)
    r = sess.reader()
    for _ in range(4):
        r.next_batch(timeout_s=10)
    sess.checkpoint({"w": np.float32(0)})       # aligned @ step 4
    for _ in range(5):
        r.next_batch(timeout_s=10)
    # a stray per-rank watermark claims step 9 — the aligned entry must win
    write_watermark(sess.ns, 0, Watermark(version=r.checkpoint().version,
                                          step=9))
    sess.reclaim()
    trim = read_trim_marker(sess.ns)
    assert trim is not None and trim[0] == 4, \
        f"trim must stop at the aligned checkpoint, got {trim}"
    # and the aligned entry's batches are still replayable
    resumed = TrainSession.resume(store, NS)
    r2 = resumed.reader()
    assert len([r2.next_batch(timeout_s=10) for _ in range(6)]) == 6


# ---------------------------------------------------------------------------
# fsck: RunManifest <-> manifest <-> trim audits
# ---------------------------------------------------------------------------

def _aligned_run(store):
    sess = TrainSession(store, Topology(dp=1, cp=1), namespace=NS)
    _fill(sess, 6)
    r = sess.reader()
    for _ in range(3):
        r.next_batch(timeout_s=10)
    sess.checkpoint({"w": np.arange(3, dtype=np.float32)})
    return sess


def test_fsck_clean_on_aligned_run():
    store = MemoryObjectStore()
    _aligned_run(store)
    report = fsck(Namespace(store, NS))
    assert report.clean, report.summary()


def test_fsck_flags_torn_model_checkpoint():
    store = MemoryObjectStore()
    sess = _aligned_run(store)
    leaf = [k for k in store.list(sess.ns.key("checkpoints"))
            if "leaf-" in k][0]
    store.delete(leaf)
    report = fsck(Namespace(store, NS))
    assert any(i.kind == "torn-model-checkpoint" for i in report.issues)
    assert not report.clean


def test_fsck_flags_trim_past_aligned_cursor():
    store = MemoryObjectStore()
    sess = _aligned_run(store)
    store.put(sess.ns.trim_key(),
              msgpack.packb({"safe_step": 99, "safe_version": -1}))
    report = fsck(Namespace(store, NS))
    assert any(i.kind == "trim-skew" for i in report.issues)


def test_fsck_orphan_model_upload_detected_and_repaired():
    store = MemoryObjectStore()
    sess = _aligned_run(store)                 # aligned @ step 3
    r = sess._readers[0]
    for _ in range(2):
        r.next_batch(timeout_s=10)
    # simulate the fatal window: upload @5 with no RunManifest commit...
    upload_model_state(sess.ns, 5, {"w": np.zeros(2, np.float32)})
    report = fsck(Namespace(store, NS))
    assert any(i.kind == "pending-model-checkpoint" for i in report.issues)
    # ...then a later aligned checkpoint supersedes it -> safe orphan
    r.next_batch(timeout_s=10)
    sess.checkpoint({"w": np.zeros(3, np.float32)})  # aligned @ step 6 > 5
    report = fsck(Namespace(store, NS))
    assert any(i.kind == "orphan-model-checkpoint" for i in report.issues)
    assert not report.clean
    fsck(Namespace(store, NS), repair=True)
    assert fsck(Namespace(store, NS)).clean


def test_fsck_flags_cursor_with_no_retained_manifests():
    """Catastrophic manifest loss must read as NOT CLEAN: the aligned
    entry's cursor names a version that no longer exists anywhere."""
    store = MemoryObjectStore()
    sess = _aligned_run(store)
    for key in store.list(sess.ns.key("manifest")):
        store.delete(key)
    report = fsck(Namespace(store, NS))
    assert any(i.kind == "runmanifest-unreadable-cursor"
               for i in report.issues), report.summary()
    assert not report.clean


def test_checkpoint_claims_directory_atomically():
    """A directory another incarnation already claimed (even with no
    MANIFEST yet — mid-upload) is never reused: the upload moves to the
    next retry-tagged directory instead of interleaving leaf objects."""
    store = MemoryObjectStore()
    sess = TrainSession(store, Topology(dp=1, cp=1), namespace=NS)
    _fill(sess, 4)
    r = sess.reader()
    for _ in range(2):
        r.next_batch(timeout_s=10)
    # another incarnation has claimed checkpoints/0000000002 mid-upload
    assert store.put_if_absent(
        sess.ns.key("checkpoints", "0000000002", "CLAIM"), b"claimed")
    entry = sess.checkpoint({"w": np.float32(7)})
    assert "0000000002-r1/" in entry.model_key
    resumed = TrainSession.resume(store, NS)
    state = resumed.restore_model({"w": np.float32(0)})
    assert float(np.asarray(state["w"])) == 7.0


def test_fsck_orphans_torn_upload_superseded_at_same_step():
    """The common cadence case: crash between upload and commit at step N,
    resume, replay, re-checkpoint at the SAME step N (lands in a retry-tagged
    dir). The torn untagged dir is superseded and must repair away."""
    store = MemoryObjectStore(faults=FaultInjector())
    sess = TrainSession(store, Topology(dp=1, cp=1), namespace=NS)
    _fill(sess, 8)
    r = sess.reader()
    for _ in range(2):
        r.next_batch(timeout_s=10)
    sess.checkpoint({"w": np.float32(1)})               # aligned @ 2
    for _ in range(2):
        r.next_batch(timeout_s=10)
    store.faults.crash_on("cput", key_substr=".rm", nth=1)
    with pytest.raises(InjectedCrash):
        sess.checkpoint({"w": np.float32(2)})           # torn upload @ 4
    store.faults = None

    resumed = TrainSession.resume(store, NS)
    r2 = resumed.reader()
    for _ in range(2):
        r2.next_batch(timeout_s=10)
    entry = resumed.checkpoint({"w": np.float32(3)})    # re-bind @ step 4
    assert "-r1/" in entry.model_key                    # torn dir untouched
    report = fsck(Namespace(store, NS))
    assert any(i.kind == "orphan-model-checkpoint" for i in report.issues)
    fsck(Namespace(store, NS), repair=True)
    assert fsck(Namespace(store, NS)).clean
    # the bound retry dir still restores
    again = TrainSession.resume(store, NS)
    assert float(np.asarray(again.restore_model({"w": np.float32(0)})["w"])) \
        == 3.0


def test_fsck_flags_corrupt_and_torn_runmanifest_chain():
    store = MemoryObjectStore()
    sess = _aligned_run(store)
    runs = sess.runs
    store.put(runs.key(2), b"not-msgpack")     # gap (seq 1) + corrupt entry
    report = fsck(Namespace(store, NS))
    kinds = {i.kind for i in report.issues}
    assert "torn-runmanifest-chain" in kinds
    assert "corrupt-runmanifest" in kinds


# ---------------------------------------------------------------------------
# Legacy token schema guard (satellite: versioned encode())
# ---------------------------------------------------------------------------

def test_v1_tokens_fail_with_clear_error():
    v1 = base64.urlsafe_b64encode(msgpack.packb(
        {"m": "bwck1", "b": "tgb", "v": 3, "s": 7})).decode("ascii")
    with pytest.raises(ValueError, match="retired.*re-checkpoint"):
        Checkpoint.decode(v1)
    # current tokens round-trip with the new fields
    ck = Checkpoint("tgb", version=3, step=7, topology=(2, 1), data_dp=2,
                    mix_pos=None)
    assert Checkpoint.decode(ck.encode()) == ck


# ---------------------------------------------------------------------------
# Twins of tests/test_elastic.py: TrainSession across a factor DP resize
# ---------------------------------------------------------------------------

def _flat(readers, n_steps):
    """n_steps global batches as one concatenated byte string."""
    out = []
    for _ in range(n_steps):
        batches = [r.next_batch(timeout_s=10) for r in readers]
        assert len({b.step for b in batches}) == 1
        out.append(b"".join(b.payload for b in batches))
    return b"".join(out)


@pytest.mark.parametrize("new_dp", [4, 1])
def test_train_session_elastic_resume(new_dp):
    store = MemoryObjectStore()
    topo = Topology(dp=2, cp=1)
    sess = TrainSession(store, topo, namespace=NS)
    _fill(sess, 14, nbytes=192)
    readers = [sess.reader(dp_rank=d) for d in range(2)]
    _flat(readers, 4)
    sess.checkpoint({"w": np.arange(4, dtype=np.float32)})
    baseline = _flat(readers, 8)

    resumed = TrainSession.resume(store, NS,
                                  topology=Topology(dp=new_dp, cp=1))
    assert resumed.resume_step == convert_logical_step(4, 2, new_dp)
    state = resumed.restore_model({"w": np.zeros(4, np.float32)})
    assert np.array_equal(np.asarray(state["w"]),
                          np.arange(4, dtype=np.float32))
    new_readers = [resumed.reader(dp_rank=d) for d in range(new_dp)]
    assert _flat(new_readers, 8 * 2 // new_dp) == baseline
    # writers vended after the resume keep the ORIGINAL materialized layout
    _fill(resumed, 2, nbytes=192)
    view = resumed.manifest_view()
    assert {t.dp for t in view.tgbs} == {2}


def test_checkpoint_after_resize_never_overwrites_bound_model():
    """dp=2 run checkpoints at logical 8 (data step 8); resumed at dp=4 the
    trainer reaches logical 8 again — a DIFFERENT position (data step 16).
    The upload must land in a fresh directory, and a crash before the new
    entry's commit must still restore the dp=2 entry's exact model."""
    store = MemoryObjectStore()
    sess = TrainSession(store, Topology(dp=2, cp=1), namespace=NS)
    _fill(sess, 20, nbytes=192)
    readers = [sess.reader(dp_rank=d) for d in range(2)]
    _flat(readers, 8)
    sess.checkpoint({"w": np.float32(8.0)})        # binds data step 8

    resumed = TrainSession.resume(store, NS, topology=Topology(dp=4, cp=1))
    r4 = [resumed.reader(dp_rank=d) for d in range(4)]
    _flat(r4, 4)                                   # logical 4 -> 8 @ dp=4
    # the crash window at logical 8 (data 16): upload lands, commit doesn't
    upload_model_state(resumed.ns, 16, {"w": np.float32(99.0)})
    again = TrainSession.resume(store, NS)
    state = again.restore_model({"w": np.float32(0.0)})
    assert float(np.asarray(state["w"])) == 8.0, \
        "the bound dp=2 model was clobbered by the resized trainer's upload"


def test_fsck_never_orphans_live_resized_upload():
    """fsck must compare dirs and entries in materialized units: a resized
    trainer's in-flight upload AHEAD of the last aligned entry is pending,
    never a safe orphan."""
    store = MemoryObjectStore()
    sess = TrainSession(store, Topology(dp=2, cp=1), namespace=NS)
    _fill(sess, 16, nbytes=192)
    readers = [sess.reader(dp_rank=d) for d in range(2)]
    _flat(readers, 10)
    sess.checkpoint({"w": np.float32(0)})          # aligned @ data step 10

    resumed = TrainSession.resume(store, NS, topology=Topology(dp=4, cp=1))
    r4 = [resumed.reader(dp_rank=d) for d in range(4)]
    _flat(r4, 1)                                   # logical 6 = data 12 > 10
    upload_model_state(resumed.ns, 12, {"w": np.float32(1)})  # mid-commit
    report = fsck(Namespace(store, NS))
    kinds = {i.kind for i in report.issues}
    assert "orphan-model-checkpoint" not in kinds
    assert "pending-model-checkpoint" in kinds


def test_runmanifest_append_refuses_regressive_entry():
    store = MemoryObjectStore()
    runs = RunManifestStore(Namespace(store, NS))
    new = Checkpoint("tgb", version=3, step=30, topology=(1, 1), data_dp=1)
    runs.append(step=30, model_key="m30", data_token=new.encode(),
                topology=(1, 1), data_dp=1)
    stale = Checkpoint("tgb", version=2, step=20, topology=(1, 1), data_dp=1)
    with pytest.raises(RunManifestError, match="regressive"):
        runs.append(step=20, model_key="m20", data_token=stale.encode(),
                    topology=(1, 1), data_dp=1)


def test_elastic_watermarks_trim_in_materialized_units():
    store = MemoryObjectStore()
    sess = TrainSession(store, Topology(dp=2, cp=1), namespace=NS)
    _fill(sess, 12, nbytes=192)
    readers = [sess.reader(dp_rank=d) for d in range(2)]
    _flat(readers, 6)
    sess.checkpoint({"w": np.float32(0)})

    resumed = TrainSession.resume(store, NS, topology=Topology(dp=4, cp=1))
    r4 = [resumed.reader(dp_rank=d) for d in range(4)]
    _flat(r4, 2)                             # logical steps 3..4 @ dp=4
    resumed.checkpoint({"w": np.float32(1)})  # aligned @ logical 5 = tgb 10
    resumed.reclaim()
    trim = read_trim_marker(resumed.ns)
    assert trim is not None and trim[0] == 10, trim


# ---------------------------------------------------------------------------
# Twins of tests/test_train.py's checkpoint tests (tensor leaves)
# ---------------------------------------------------------------------------

@pytest.fixture
def ns():
    return Namespace(MemoryObjectStore(), "runs/test")


def test_checkpoint_roundtrip_and_watermarks(ns):
    state = {
        "params": {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
                   "b": torch.ones((3,), dtype=torch.bfloat16)},
        "opt": {"step": torch.tensor(7, dtype=torch.int32)},
    }
    save_checkpoint(ns, step=7, state=state, cursor=(12, 34),
                    consumer_ranks=[0, 1])
    assert list_checkpoints(ns) == [7]
    template = {"params": {k: torch.zeros_like(v)
                           for k, v in state["params"].items()},
                "opt": {"step": torch.zeros((), dtype=torch.int32)}}
    restored, cursor, step = restore_checkpoint(ns, template)
    assert cursor == (12, 34) and step == 7
    for path in (("params", "w"), ("params", "b"), ("opt", "step")):
        a, b = restored[path[0]][path[1]], state[path[0]][path[1]]
        assert a.dtype == b.dtype
        assert torch.equal(a.float(), b.float())
    wms = read_watermarks(ns)
    assert wms[0].version == 12 and wms[0].step == 34
    assert 1 in wms


def test_checkpoint_restore_specific_step(ns):
    for s in (5, 10):
        save_checkpoint(ns, step=s, state={"x": torch.tensor(float(s))},
                        cursor=(s, s))
    restored, cursor, step = restore_checkpoint(ns, {"x": torch.tensor(0.0)},
                                                step=5)
    assert float(restored["x"]) == 5.0 and step == 5


# ---------------------------------------------------------------------------
# The port's own rules
# ---------------------------------------------------------------------------

def _bits(t: torch.Tensor) -> bytes:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes()


def test_restored_leaves_take_the_recorded_dtype_and_shape(ns):
    """The template gives the structure only: a leaf restores with the dtype
    and shape its MANIFEST records, bit for bit, on the template's device."""
    g = torch.Generator().manual_seed(0)
    state = {"a": torch.randn(3, 5, generator=g).to(torch.bfloat16),
             "b": [torch.randn(4, generator=g),
                   torch.tensor(-3, dtype=torch.int32)],
             "c": (torch.zeros(0, 2), torch.tensor([True, False]))}
    key = upload_model_state(ns, 1, state)
    template = {"a": torch.zeros(1), "b": [torch.zeros(1), torch.zeros(1)],
                "c": (torch.zeros(1), torch.zeros(1))}
    got, doc = load_model_state(ns, key, template)
    assert isinstance(got["b"], list) and isinstance(got["c"], tuple)
    pairs = [(got["a"], state["a"]), (got["b"][0], state["b"][0]),
             (got["b"][1], state["b"][1]), (got["c"][0], state["c"][0]),
             (got["c"][1], state["c"][1])]
    for a, b in pairs:
        assert (a.dtype, a.shape, a.device) == (b.dtype, b.shape, b.device)
        assert _bits(a) == _bits(b)
    assert [e["path"] for e in doc["leaves"]] == ["a", "b/0", "b/1", "c/0",
                                                  "c/1"]
    assert [e["dtype"] for e in doc["leaves"]] == [
        "bfloat16", "float32", "int32", "float32", "bool"]


def test_restored_tensors_own_their_memory(ns):
    """The optimizer updates leaves in place: a restored leaf must not alias
    the store's object, and a second restore reads the checkpoint again."""
    key = upload_model_state(ns, 1, {"w": torch.arange(4.0)})
    first, _ = load_model_state(ns, key, {"w": torch.zeros(4)})
    first["w"].add_(100.0)
    again, _ = load_model_state(ns, key, {"w": torch.zeros(4)})
    assert torch.equal(again["w"], torch.arange(4.0))


def test_restored_state_dies_with_its_last_reference(ns):
    """A restore holds the template and the restored state together; at
    full width each is 24 GiB of the card's 80, so nothing may keep a
    dropped restored state alive until the cycle collector runs."""
    import gc
    import weakref

    key = upload_model_state(ns, 1, {"a": {"w": torch.arange(4.0)},
                                     "b": [torch.ones(2), torch.zeros(3)]})
    template = {"a": {"w": torch.zeros(1)}, "b": [torch.zeros(1)] * 2}
    gc.collect()
    gc.disable()
    try:
        got, _ = load_model_state(ns, key, template)
        refs = [weakref.ref(got["a"]["w"]), weakref.ref(got["b"][1])]
        del got
        assert [r() for r in refs] == [None, None]
    finally:
        gc.enable()


def test_bf16_leaves_round_trip_without_ml_dtypes(ns, monkeypatch):
    """Writing and reading tensor leaves never imports ml_dtypes (the
    card's machine has none); only a numpy template leaf asks for it."""
    import builtins
    real_import = builtins.__import__

    def guarded(name, *a, **kw):
        if name.split(".")[0] == "ml_dtypes":
            raise ImportError("ml_dtypes is blocked")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", guarded)
    x = torch.tensor([1.0, -2.5, 3e-3, 65504.0]).to(torch.bfloat16)
    key = upload_model_state(ns, 2, {"x": x})
    got, _ = load_model_state(ns, key, {"x": torch.zeros(1)})
    assert got["x"].dtype == torch.bfloat16 and _bits(got["x"]) == _bits(x)
    with pytest.raises(ImportError, match="ml_dtypes"):
        load_model_state(ns, key, {"x": np.zeros(1, np.float32)})


def test_numpy_template_leaves_restore_as_numpy_arrays(ns):
    ml_dtypes = pytest.importorskip("ml_dtypes")
    x = torch.tensor([1.0, 0.5, -7.0]).to(torch.bfloat16)
    key = upload_model_state(ns, 3, {"x": x, "s": torch.tensor(2.0)})
    got, _ = load_model_state(ns, key, {"x": np.zeros(1, np.float32),
                                        "s": np.float32(0)})
    assert got["x"].dtype == np.dtype(ml_dtypes.bfloat16)
    assert got["x"].view(np.int16).tobytes() == _bits(x)
    assert isinstance(got["s"], np.ndarray) and float(got["s"]) == 2.0


def test_fsck_checks_bf16_leaf_sizes():
    """A torn bf16 leaf is caught by its size (the reference needs
    ml_dtypes for that; the port reads the itemsize from torch)."""
    store = MemoryObjectStore()
    sess = TrainSession(store, Topology(dp=1, cp=1), namespace=NS)
    _fill(sess, 4)
    r = sess.reader()
    r.next_batch(timeout_s=10)
    sess.checkpoint({"w": torch.ones(8, dtype=torch.bfloat16)})
    assert fsck(Namespace(store, NS)).clean
    leaf = [k for k in store.list(sess.ns.key("checkpoints"))
            if "leaf-" in k][0]
    store.put(leaf, store.get(leaf)[:-2])
    report = fsck(Namespace(store, NS))
    assert any(i.kind == "torn-model-checkpoint" and "16 B" in i.detail
               for i in report.issues), report.summary()
