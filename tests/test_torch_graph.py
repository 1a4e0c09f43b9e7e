"""The port's derived streams (``repro_torch.graph``) on the CPU.

Twins of every test of ``tests/test_graph.py``: provenance records and
content addressing, the ops and the OpGraph, the derive cursor's fencing,
the DeriveWorker's cold derive, kill-and-replay and graph changes, derived
streams on the ordinary read path (TrainSession, MixedReader, elastic
restore), ``inspect_run`` and the fsck audits of a derived stream. Then
across packages: ``params_hash`` and the canonical provenance bytes are
identical; a window one package's worker began and was killed in before
its cursor commit is finished by the other's worker with no upload, and
the derived objects equal a derivation by one package alone; fsck of either
package reports the same issues on a derived run.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro_torch.core import (ManifestStore, MemoryObjectStore,  # noqa: E402
                              MeshPosition, Namespace, Producer)
from repro_torch.core.consumer import Consumer  # noqa: E402
from repro_torch.data.packing import GlobalBatchPacker  # noqa: E402
from repro_torch.dataplane import Topology, open_dataplane  # noqa: E402
from repro_torch.graph import (DeriveCursor, DeriveCursorError,  # noqa: E402
                               DeriveCursorStore, DeriveWorker, DedupOp,
                               FilterOp, GraphError, MapOp, OpGraph, PackOp,
                               Provenance, params_hash)
from repro_torch.ops import fsck  # noqa: E402
from repro_torch.ops.inspect import inspect_run  # noqa: E402
from repro_torch.run import TrainSession  # noqa: E402
from repro_torch.streams import MultiStreamSession  # noqa: E402

NS = "runs/test_graph"
GB, SL, DP = 8, 16, 2
TOPO = Topology(dp=DP, cp=1, global_batch=GB, seq_len=SL)


def _keep_even(rows):
    return rows[:, 0] % 2 == 0


def _fill_source(store, n_tgbs, seed=0, name="raw", ns=NS):
    """Publish n_tgbs deterministic token-grid TGBs; returns the grids."""
    run_ns = Namespace(store, ns)
    packer = GlobalBatchPacker(GB, SL, DP, 1)
    p = Producer(run_ns.stream(name), "P", dp=DP, cp=1)
    p.recover()
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 1 << 15, GB * SL * n_tgbs,
                        dtype=np.int64).astype(np.int32)
    for b in packer.add_tokens(toks):
        p.write_tgb(slice_payloads=b.slices, num_samples=b.num_samples,
                    token_count=b.token_count)
        p.maybe_commit(force=True)
    p.finalize()
    return [toks[i * GB * SL:(i + 1) * GB * SL].reshape(GB, SL)
            for i in range(n_tgbs)]


def _graph(out_gb=4, out_dp=1, pack_version=1):
    g = OpGraph("test")
    g.add(FilterOp("evens", _keep_even), source="raw", output="rows")
    g.add(PackOp("pack", global_batch=out_gb, seq_len=SL, dp=out_dp, cp=1,
                 version=pack_version), source="rows", output="filtered")
    return g


def _expected_outputs(grids, window, out_gb):
    """Reference derivation: filter each window's rows, chunk into out_gb
    batches, zero-pad the window's remainder (PackOp.flush semantics)."""
    outs = []
    for w in range(0, len(grids), window):
        rows = np.concatenate([g[_keep_even(g)] for g in grids[w:w + window]])
        for i in range(0, len(rows), out_gb):
            chunk = rows[i:i + out_gb]
            if chunk.shape[0] and chunk.shape[0] < out_gb:
                pad = np.zeros((out_gb - chunk.shape[0], SL), np.int32)
                chunk = np.concatenate([chunk, pad])
            if chunk.shape[0]:
                outs.append(chunk)
    return outs


def _read_derived(store, n, out_dp=1, name="filtered", ns=NS):
    """Decode every derived global batch through the ordinary read path."""
    cons = Consumer(Namespace(store, ns).stream(name), MeshPosition(0, 0, 1, 1))
    out = []
    for _ in range(n):
        parts = [cons.next_batch(timeout_s=5) for _ in range(out_dp)]
        out.append(np.frombuffer(b"".join(parts), np.int32).reshape(-1, SL))
    return out


# ---------------------------------------------------------------------------
# Provenance records and content addressing
# ---------------------------------------------------------------------------

def test_provenance_roundtrip_and_canonical_hash():
    p = Provenance(src_stream="raw", src_tgb_ids=("P-0", "P-1"),
                   op="evens@1>pack@1", params="ab", graph="cd", out_index=2)
    assert Provenance.from_wire(p.to_wire()) == p
    assert p.content_hash() == p.content_hash()
    assert len(p.content_token()) == 16
    # every field feeds the address
    for other in [p.__class__(**{**p.__dict__, "out_index": 3}),
                  p.__class__(**{**p.__dict__, "graph": "ee"}),
                  p.__class__(**{**p.__dict__, "src_tgb_ids": ("P-0",)})]:
        assert other.content_hash() != p.content_hash()
    with pytest.raises(ValueError, match="schema"):
        Provenance.from_wire({"src": []})


def test_params_hash_is_order_insensitive():
    assert params_hash({"a": 1, "b": [2, 3]}) == params_hash({"b": [2, 3], "a": 1})
    assert params_hash({"a": 1}) != params_hash({"a": 2})
    assert params_hash(None) == params_hash({})


# ---------------------------------------------------------------------------
# Satellite: GlobalBatchPacker.flush + writer flush_tokens
# ---------------------------------------------------------------------------

def test_packer_flush_pads_final_partial_batch():
    p = GlobalBatchPacker(4, 8, 1, 1)
    assert p.flush() is None                       # empty buffer: nothing
    p.add_tokens(np.arange(4 * 8 + 10, dtype=np.int32))  # one full + 10 over
    b = p.flush(pad_token=7)
    assert b is not None
    grid = np.frombuffer(b.slices[(0, 0)], np.int32).reshape(4, 8)
    assert grid.ravel()[:10].tolist() == list(range(32, 42))
    assert (grid.ravel()[10:] == 7).all()
    assert b.token_count == 10                     # real tokens, not padding
    assert p.flush() is None                       # buffer drained


def test_writer_flush_tokens_publishes_padded_remainder():
    store = MemoryObjectStore()
    sess = open_dataplane(store, Topology(dp=1, cp=1, global_batch=4,
                                          seq_len=8), backend="tgb",
                          namespace=NS)
    with sess.writer("w0") as w:
        assert w.flush_tokens() is None            # nothing buffered yet
        w.write_tokens(np.arange(20, dtype=np.int32))  # partial batch only
        off = w.flush_tokens(pad_token=3)
        assert off == 0
    r = sess.reader()
    got = r.next_batch(timeout_s=5).tokens.ravel()
    assert got[:20].tolist() == list(range(20))
    assert (got[20:] == 3).all()


# ---------------------------------------------------------------------------
# Ops
# ---------------------------------------------------------------------------

def test_map_op_must_preserve_shape():
    op = MapOp("neg", lambda r: -r)
    rows = np.arange(12, dtype=np.int32).reshape(3, 4)
    assert (op.process(rows) == -rows).all()
    bad = MapOp("drop", lambda r: r[:1])
    with pytest.raises(ValueError, match="shape"):
        bad.process(rows)


def test_filter_op_validates_mask():
    rows = np.arange(12, dtype=np.int32).reshape(3, 4)
    assert FilterOp("f", lambda r: r[:, 0] > 3).process(rows).shape == (2, 4)
    with pytest.raises(ValueError, match="one bool per row"):
        FilterOp("g", lambda r: r > 3).process(rows)


def test_dedup_op_scope_is_one_quantum():
    op = DedupOp()
    rows = np.array([[1, 2], [3, 4], [1, 2]], np.int32)
    assert op.process(rows).shape == (2, 2)
    assert op.process(rows[:1]).shape == (0, 2)    # seen within the quantum
    op.reset()
    assert op.process(rows[:1]).shape == (1, 2)    # fresh quantum


def test_bad_op_ids_rejected():
    with pytest.raises(ValueError):
        MapOp("a/b", lambda r: r)
    with pytest.raises(ValueError):
        MapOp("a>b", lambda r: r)


# ---------------------------------------------------------------------------
# OpGraph structure
# ---------------------------------------------------------------------------

def test_graph_validation_and_chain_resolution():
    g = _graph()
    assert g.sources == ["raw"]
    assert g.outputs == ["filtered"]
    ch = g.chain("filtered")
    assert ch.source == "raw" and ch.output == "filtered"
    assert ch.signature == "evens@1>pack@1"
    with pytest.raises(GraphError, match="already has a producer"):
        g.add(MapOp("m", lambda r: r), source="x", output="rows")
    with pytest.raises(GraphError, match="cycle"):
        OpGraph().add(MapOp("m", lambda r: r), source="a", output="b") \
                 .add(MapOp("n", lambda r: r), source="b", output="a")
    with pytest.raises(GraphError, match="virtual"):
        g.chain("rows")                            # row edge: not materialized
    with pytest.raises(GraphError, match="no op produces"):
        g.chain("nope")
    # a PackOp output consumed by a fused row chain is a hard error
    g2 = _graph()
    g2.add(MapOp("m", lambda r: r), source="filtered", output="virt")
    g2.add(PackOp("p2", global_batch=4, seq_len=SL), source="virt",
           output="repacked")
    with pytest.raises(GraphError, match="materialized"):
        g2.chain("repacked")


def test_graph_hash_tracks_identity():
    assert _graph().graph_hash() == _graph().graph_hash()
    assert _graph().graph_hash() != _graph(pack_version=2).graph_hash()
    assert _graph().graph_hash() != _graph(out_gb=2).graph_hash()


# ---------------------------------------------------------------------------
# DeriveCursorStore
# ---------------------------------------------------------------------------

def test_derive_cursor_commit_fencing():
    ns = Namespace(MemoryObjectStore(), NS).stream("filtered")
    cs = DeriveCursorStore(ns)
    assert cs.latest() is None
    dc = cs.append(src_step=2, out_seq=3, graph="g1", op="f@1>p@1")
    assert (dc.seq, dc.src_step, dc.out_seq) == (0, 2, 3)
    cs.append(src_step=4, out_seq=6, graph="g1", op="f@1>p@1")
    assert cs.latest().src_step == 4
    with pytest.raises(DeriveCursorError, match="regressive"):
        cs.append(src_step=3, out_seq=9, graph="g1", op="f@1>p@1")
    with pytest.raises(DeriveCursorError, match="fresh stream"):
        cs.append(src_step=9, out_seq=9, graph="g2", op="f@2>p@1")
    with pytest.raises(DeriveCursorError, match="schema"):
        DeriveCursor.unpack(b"\x81\xa6schema\x63")


# ---------------------------------------------------------------------------
# DeriveWorker: cold derive, resume, replay
# ---------------------------------------------------------------------------

def test_cold_derive_matches_reference():
    store = MemoryObjectStore()
    grids = _fill_source(store, 6)
    w = DeriveWorker(Namespace(store, NS), _graph(), TOPO, window_steps=2)
    stats = w.run(max_source_steps=6, timeout_s=5)
    want = _expected_outputs(grids, window=2, out_gb=4)
    assert stats.tgbs_derived == len(want)
    got = _read_derived(store, len(want))
    for g, ref in zip(got, want):
        assert (g == ref).all()
    # every derived TGB carries provenance naming real source TGBs
    m = ManifestStore(Namespace(store, NS).stream("filtered"))
    view = m.load_view(m.latest_version())
    assert len(view.derived_tgbs()) == len(view.tgbs) == len(want)
    for _s, t in view.derived_tgbs():
        prov = Provenance.from_wire(t.provenance)
        assert prov.src_stream == "raw"
        assert all(i.startswith("P-") for i in prov.src_tgb_ids)
        assert prov.content_token() in t.object_key


def test_restart_after_kill_is_byte_identical_with_zero_rederivation():
    store = MemoryObjectStore()
    _fill_source(store, 6)
    ns = Namespace(store, NS)
    DeriveWorker(ns, _graph(), TOPO, window_steps=2).run(
        max_source_steps=6, timeout_s=5)
    out_ns = ns.stream("filtered")
    objects_before = {k: bytes(store.get(k))
                      for k in store.list(out_ns.key("tgb"))}
    # simulate a crash between publish and cursor commit: drop the last cursor
    cs = DeriveCursorStore(out_ns)
    last = cs.seqs()[-1]
    store.delete(cs.key(last))
    w2 = DeriveWorker(ns, _graph(), TOPO, window_steps=2)
    stats = w2.run(max_source_steps=6, timeout_s=5)
    assert stats.resumed_src_step == 4              # replayed the last window
    assert stats.store_hits == stats.tgbs_derived > 0, \
        "replay must land on existing content addresses, not re-upload"
    objects_after = {k: bytes(store.get(k))
                     for k in store.list(out_ns.key("tgb"))}
    assert objects_after == objects_before          # byte-identical, no dups
    # and a second restart is a pure no-op
    stats3 = DeriveWorker(ns, _graph(), TOPO, window_steps=2).run(
        max_source_steps=6, timeout_s=5)
    assert stats3.source_steps == 0 and stats3.resumed_src_step == 6


def test_changed_graph_refuses_existing_output_stream():
    store = MemoryObjectStore()
    _fill_source(store, 2)
    ns = Namespace(store, NS)
    DeriveWorker(ns, _graph(), TOPO, window_steps=2).run(
        max_source_steps=2, timeout_s=5)
    bumped = DeriveWorker(ns, _graph(pack_version=2), TOPO, window_steps=2)
    with pytest.raises(DeriveCursorError, match="fresh stream"):
        bumped.run(max_source_steps=2, timeout_s=5)


def test_dedup_map_chain_and_multi_output_graph():
    store = MemoryObjectStore()
    ns = Namespace(store, NS)
    # source with duplicated rows inside one TGB
    packer = GlobalBatchPacker(GB, SL, DP, 1)
    p = Producer(ns.stream("raw"), "P", dp=DP, cp=1)
    row = np.arange(SL, dtype=np.int32)
    grid = np.stack([row + (i // 2) for i in range(GB)])  # each row twice
    for b in packer.add_tokens(grid.ravel()):
        p.write_tgb(slice_payloads=b.slices, num_samples=b.num_samples,
                    token_count=b.token_count)
    p.finalize()
    g = OpGraph("multi")
    g.add(DedupOp(), source="raw", output="uniq")
    g.add(MapOp("inc", lambda r: np.where(r >= 0, r + 1, r) - 1 + 1),
          source="uniq", output="mapped")
    g.add(PackOp("pack", global_batch=4, seq_len=SL), source="mapped",
          output="clean")
    g.add(PackOp("pack2", global_batch=8, seq_len=SL), source="raw",
          output="copy")
    assert g.outputs == ["clean", "copy"]
    with pytest.raises(GraphError, match="pass output="):
        DeriveWorker(ns, g, TOPO)
    stats = DeriveWorker(ns, g, TOPO, output="clean").run(
        max_source_steps=1, timeout_s=5)
    assert stats.rows_in == GB and stats.rows_out == GB // 2
    got = _read_derived(store, 1, name="clean")[0]
    assert (got == np.stack([row + 1 + i for i in range(4)])).all()


# ---------------------------------------------------------------------------
# Derived streams on the ordinary read path
# ---------------------------------------------------------------------------

def test_train_session_consumes_derived_stream_end_to_end():
    """Acceptance path: filter -> pack graph from a live source stream,
    its output consumed by a TrainSession with aligned checkpointing."""
    store = MemoryObjectStore()
    grids = _fill_source(store, 4)
    g = _graph(out_gb=GB, out_dp=DP)               # same grid as the source
    session = MultiStreamSession(store, TOPO, streams={"raw": 1.0},
                                 namespace=NS)
    stats = session.derive_worker(g, window_steps=2).run(
        max_source_steps=4, timeout_s=5)
    assert stats.tgbs_derived > 0
    want = _expected_outputs(grids, window=2, out_gb=GB)

    train = TrainSession(store, TOPO, namespace=f"{NS}/streams/filtered")
    readers = [train.reader(dp_rank=d) for d in range(DP)]
    for ref in want[:2]:
        got = np.concatenate([r.next_batch(timeout_s=5).tokens
                              for r in readers])
        assert (got == ref).all()
    train.checkpoint({"w": np.ones(3, np.float32)})
    resumed = TrainSession.resume(store, f"{NS}/streams/filtered",
                                  topology=TOPO)
    assert resumed.resume_step == 2
    readers2 = [resumed.reader(dp_rank=d) for d in range(DP)]
    for ref in want[2:]:
        got = np.concatenate([r.next_batch(timeout_s=5).tokens
                              for r in readers2])
        assert (got == ref).all()


def test_mixed_reader_mixes_raw_and_derived_with_composite_checkpoint():
    store = MemoryObjectStore()
    _fill_source(store, 6)
    ns = Namespace(store, NS)
    DeriveWorker(ns, _graph(out_gb=GB, out_dp=DP), TOPO, window_steps=3).run(
        max_source_steps=6, timeout_s=5)
    session = open_dataplane(store, TOPO, backend="tgb", namespace=NS,
                             streams={"raw": 0.5, "filtered": 0.5},
                             mix_seed=3)
    r = session.reader(dp_rank=0, cp_rank=0)
    n = 8
    seen = [r.next_batch(timeout_s=5) for _ in range(4)]
    assert {b.stream for b in seen} == {"raw", "filtered"}
    token = r.checkpoint()
    assert token.composite
    lost = [r.next_batch(timeout_s=5).payload for _ in range(n - 4)]
    r2 = session.reader(dp_rank=0, cp_rank=0, resume=token)
    replay = [r2.next_batch(timeout_s=5).payload for _ in range(n - 4)]
    assert replay == lost


def test_elastic_resize_restore_over_derived_stream():
    store = MemoryObjectStore()
    _fill_source(store, 8)
    ns = Namespace(store, NS)
    DeriveWorker(ns, _graph(out_gb=GB, out_dp=DP), TOPO, window_steps=4).run(
        max_source_steps=8, timeout_s=5)
    dns = f"{NS}/streams/filtered"
    sess = open_dataplane(store, TOPO, backend="tgb", namespace=dns)
    readers = [sess.reader(dp_rank=d) for d in range(DP)]
    steps = ManifestStore(ns.stream("filtered")).load_view(
        ManifestStore(ns.stream("filtered")).latest_version()).total_steps
    half = steps // 2

    def flat(rs, k):
        return b"".join(b"".join(r.next_batch(timeout_s=5).payload
                                 for r in rs) for _ in range(k))

    flat(readers, half)
    token = readers[0].checkpoint().encode()
    baseline = flat(readers, steps - half)
    resized = open_dataplane(store, Topology(dp=1, cp=1, global_batch=GB,
                                             seq_len=SL), backend="tgb",
                             namespace=dns, resume=token)
    rr = [resized.reader(dp_rank=0)]
    assert flat(rr, (steps - half) * DP) == baseline


# ---------------------------------------------------------------------------
# Stream/session accessors + ops integration
# ---------------------------------------------------------------------------

def test_stream_accessors_and_inspect_surface_provenance():
    store = MemoryObjectStore()
    _fill_source(store, 2)
    ns = Namespace(store, NS)
    DeriveWorker(ns, _graph(), TOPO, window_steps=2).run(
        max_source_steps=2, timeout_s=5)
    session = MultiStreamSession(store, TOPO,
                                 streams={"raw": 0.5, "filtered": 0.5},
                                 namespace=NS)
    assert not session.streams["raw"].is_derived
    assert session.streams["filtered"].is_derived
    assert session.streams["raw"].latest_derive_cursor() is None
    dc = session.streams["filtered"].latest_derive_cursor()
    assert dc.src_step == 2 and dc.op == "evens@1>pack@1"

    info = inspect_run(ns)
    assert "derive" not in info["streams"]["raw"]
    dv = info["streams"]["filtered"]["derive"]
    assert dv["cursor"]["src_step"] == 2
    assert dv["derived_tgbs"][0]["op"] == "evens@1>pack@1"
    assert dv["derived_tgbs"][0]["src"] == ["P-000000000000", "P-000000000001"]


def test_fsck_flags_torn_cursor_chain_and_dangling_provenance():
    store = MemoryObjectStore()
    _fill_source(store, 4)
    ns = Namespace(store, NS)
    DeriveWorker(ns, _graph(), TOPO, window_steps=1).run(
        max_source_steps=4, timeout_s=5)
    assert fsck(ns).clean
    out_ns = ns.stream("filtered")
    # torn chain: a middle cursor vanishes
    store.delete(DeriveCursorStore(out_ns).key(1))
    report = fsck(ns)
    kinds = {i.kind for i in report.all_issues()}
    assert "torn-derive-cursor-chain" in kinds
    assert not report.clean
    # dangling provenance: the source stream's manifests disappear
    for key in list(store.list(ns.stream("raw").key("manifest"))):
        store.delete(key)
    kinds = {i.kind for i in fsck(ns).all_issues()}
    assert "provenance-dangling" in kinds


def test_fsck_repairs_orphaned_derived_outputs():
    store = MemoryObjectStore()
    _fill_source(store, 2)
    ns = Namespace(store, NS)
    DeriveWorker(ns, _graph(), TOPO, window_steps=2).run(
        max_source_steps=2, timeout_s=5)
    # a crashed window's upload: provenance-carrying object, never committed
    out_ns = ns.stream("filtered")
    p = Producer(out_ns, "derive-0", dp=1, cp=1)
    p.recover()
    prov = Provenance(src_stream="raw", src_tgb_ids=("P-x",), op="evens@1>pack@1",
                      params="p", graph="g", out_index=0)
    p.write_tgb(slice_payloads={(0, 0): b"\0" * 4 * SL * 4},
                provenance=prov.to_wire(), content_token=prov.content_token())
    # uploaded but never committed: fsck must reclassify as a safe orphan
    report = fsck(ns)
    sub = report.streams["filtered"]
    assert any(i.kind == "orphan-derived-tgb" for i in sub.issues)
    assert len(sub.orphans) == 1 and not sub.pending
    fsck(ns, repair=True)
    assert fsck(ns).clean


# ---------------------------------------------------------------------------
# Across packages: canonical bytes, a killed window finished by the other
# package's worker, fsck on the other's derived run
# ---------------------------------------------------------------------------

def _pkg(name):
    """(core, dataplane, graph, ops) of one package."""
    pytest.importorskip("msgpack")
    if name == "repro":
        import repro.core as core
        import repro.dataplane as dp
        import repro.graph as graph
        import repro.ops as ops
    else:
        import repro_torch.core as core
        import repro_torch.dataplane as dp
        import repro_torch.graph as graph
        import repro_torch.ops as ops
    return core, dp, graph, ops


def _view(store, core):
    """``core``'s MemoryObjectStore over ``store``'s objects."""
    twin = core.MemoryObjectStore()
    twin._objects, twin._lock = store._objects, store._lock
    return twin


def _graph_of(graph, out_gb=4, out_dp=1):
    g = graph.OpGraph("test")
    g.add(graph.FilterOp("evens", _keep_even), source="raw", output="rows")
    g.add(graph.PackOp("pack", global_batch=out_gb, seq_len=SL, dp=out_dp,
                       cp=1), source="rows", output="filtered")
    return g


def _worker(name, store, faults=None, **kw):
    """``name``'s DeriveWorker over ``store``'s objects (with ``faults``)."""
    core, dp, graph, _ = _pkg(name)
    view = _view(store, core)
    view.faults = faults
    return graph.DeriveWorker(
        core.Namespace(view, NS), _graph_of(graph),
        dp.Topology(dp=DP, cp=1, global_batch=GB, seq_len=SL), **kw)


def _derived_objects(store):
    """{key: bytes} of the derived stream's TGBs and derive cursors."""
    pre = f"{NS}/streams/filtered/"
    return {k: bytes(store.get(k)) for k in store.list(pre)
            if "/tgb/" in k or "/derive/" in k}


CANONICAL_DOCS = [
    {}, None, {"b": [2, 3], "a": 1}, {"z": {"y": {"x": [1, "s", None]}}},
    {"f": 1.5, "neg": -7, "big": 2 ** 40, "t": (1, 2), "ok": True},
    {"global_batch": 4, "seq_len": 1024, "dp": 2, "cp": 2, "pad_token": 0},
    {"evens@1": {}, "pack@1": {"global_batch": 8, "seq_len": 16, "dp": 2,
                               "cp": 1, "pad_token": 0}},
    {"u": "ünïcode", "long": "x" * 40, "bin": b"\x00\xff"},
]


@pytest.mark.parametrize("doc", CANONICAL_DOCS)
def test_canonical_bytes_and_params_hash_equal_the_reference(doc):
    pytest.importorskip("msgpack")
    from repro.graph.provenance import _canonical as jax_canonical
    from repro.graph.provenance import params_hash as jax_params_hash
    from repro_torch.graph.provenance import _canonical

    assert _canonical(doc) == jax_canonical(doc)
    if doc is None or isinstance(doc, dict):
        assert params_hash(doc) == jax_params_hash(doc)


def test_provenance_and_graph_identity_equal_the_reference():
    _, _, jgraph, _ = _pkg("repro")
    from repro.graph.provenance import _canonical as jax_canonical
    from repro_torch.graph.provenance import _canonical

    ours, ref = _graph_of(_pkg("repro_torch")[2]), _graph_of(jgraph)
    assert ours.graph_hash() == ref.graph_hash()
    och, rch = ours.chain("filtered"), ref.chain("filtered")
    assert (och.signature, och.params_hash) == (rch.signature,
                                                rch.params_hash)
    fields = dict(src_stream="raw", src_tgb_ids=("P-000000000000",
                                                 "P-000000000001"),
                  op=och.signature, params=och.params_hash,
                  graph=ours.graph_hash(), out_index=3)
    p, q = Provenance(**fields), jgraph.Provenance(**fields)
    assert _canonical(p.to_wire()) == jax_canonical(q.to_wire())
    assert p.content_hash() == q.content_hash()
    assert p.content_token() == q.content_token()
    dc = DeriveCursor(seq=4, src_step=8, out_seq=9, graph=ours.graph_hash(),
                      op=och.signature, worker_id="derive-0")
    jdc = jgraph.DeriveCursor(**dc.__dict__)
    assert dc.pack() == jdc.pack()
    assert jgraph.DeriveCursor.unpack(dc.pack()) == jdc
    assert DeriveCursor.unpack(jdc.pack()) == dc


@pytest.mark.parametrize("first,second", [("repro", "repro_torch"),
                                          ("repro_torch", "repro")])
def test_a_killed_window_is_finished_by_the_other_package(first, second):
    """``first``'s worker dies after its second window's uploads and
    manifest commit, before that window's cursor commit; ``second``'s
    worker replays the window with no upload and finishes the stream, whose
    objects equal a derivation by ``first`` alone."""
    c1 = _pkg(first)[0]
    store = c1.MemoryObjectStore()
    grids = _fill_source(_view(store, _pkg("repro_torch")[0]), 6)
    faults = c1.FaultInjector()
    faults.crash_on("cput", key_substr="streams/filtered/derive/", nth=2)
    w1 = _worker(first, store, faults=faults, window_steps=2)
    with pytest.raises(c1.InjectedCrash):
        w1.run(max_source_steps=6, timeout_s=5)
    assert DeriveCursorStore(Namespace(_view(store, _pkg("repro_torch")[0]),
                                       NS).stream("filtered")).seqs() == [0]
    at_kill = _derived_objects(store)

    w2 = _worker(second, store, window_steps=2)
    assert w2.recover() == 2
    assert w2.derive_window(4, timeout_s=5)
    assert w2.stats.store_hits == w2.stats.tgbs_derived > 0   # no upload
    assert {k: v for k, v in _derived_objects(store).items()
            if "/tgb/" in k} == {k: v for k, v in at_kill.items()
                                 if "/tgb/" in k}
    w2.run(max_source_steps=6, timeout_s=5)

    alone = c1.MemoryObjectStore()
    _fill_source(_view(alone, _pkg("repro_torch")[0]), 6)
    _worker(first, alone, window_steps=2).run(max_source_steps=6,
                                              timeout_s=5)
    assert _derived_objects(store) == _derived_objects(alone)
    want = _expected_outputs(grids, window=2, out_gb=4)
    got = _read_derived(_view(store, _pkg("repro_torch")[0]), len(want))
    assert all((g == w).all() for g, w in zip(got, want))


@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
def test_fsck_of_either_package_reports_the_same_issues(writer):
    core, _, graph, _ = _pkg(writer)
    store = core.MemoryObjectStore()
    _fill_source(_view(store, _pkg("repro_torch")[0]), 4)
    _worker(writer, store, window_steps=1).run(max_source_steps=4,
                                               timeout_s=5)

    def issues():
        out = {}
        for name in ("repro", "repro_torch"):
            c, _, _, ops = _pkg(name)
            r = ops.fsck(c.Namespace(_view(store, c), NS))
            out[name] = sorted((i.severity, i.kind, i.key)
                               for i in r.all_issues())
        assert out["repro"] == out["repro_torch"]
        return out["repro"]

    assert issues() == []
    out_ns = f"{NS}/streams/filtered"
    # a crashed window's upload (provenance, never committed) and a torn
    # cursor chain
    p = core.Producer(core.Namespace(store, out_ns), "derive-0", dp=1, cp=1)
    p.recover()
    prov = graph.Provenance(src_stream="raw", src_tgb_ids=("P-x",),
                            op="evens@1>pack@1", params="p", graph="g",
                            out_index=0)
    p.write_tgb(slice_payloads={(0, 0): b"\0" * 4 * SL * 4},
                provenance=prov.to_wire(),
                content_token=prov.content_token())
    store.delete(f"{out_ns}/derive/{1:08d}.dc")
    kinds = {k for _, k, _ in issues()}
    assert {"torn-derive-cursor-chain", "orphan-derived-tgb"} <= kinds


# ---------------------------------------------------------------------------
# inspect_run and fsck over streams: twins of tests/test_ops.py:132-175, and
# inspect_run of a mixed, sharded and derived run equal in both packages
# ---------------------------------------------------------------------------

def _publish(ns, n=5, pid="P", slice_bytes=64):
    p = Producer(ns, pid, dp=1, cp=1, manifests=ManifestStore(ns))
    for _ in range(n):
        p.write_tgb(uniform_slice_bytes=slice_bytes)
        p.maybe_commit(force=True)
    p.finalize()
    return p


def test_fsck_recurses_streams():
    store = MemoryObjectStore()
    session = open_dataplane(store, Topology(dp=1, cp=1), backend="tgb",
                             namespace="runs/mix",
                             streams={"a": 1.0, "b": 1.0})
    for name in session.stream_names:
        with session.writer(f"w{name}", stream=name) as w:
            for _ in range(3):
                w.write(uniform_slice_bytes=32)
    ns = Namespace(store, "runs/mix")
    report = fsck(ns)
    assert set(report.streams) == {"a", "b"}
    assert report.clean
    # an orphan inside one stream taints the run-level verdict
    a_ns = ns.stream("a")
    store.put(a_ns.tgb_key("wa", 0, "feedface"), b"x")
    report = fsck(ns)
    assert not report.clean
    assert report.streams["a"].orphans


def test_inspect_reports_run_state():
    from repro_torch.core import Reclaimer, Watermark, write_watermark

    ns = Namespace(MemoryObjectStore(), "runs/job")
    p = _publish(ns, 4)  # 4 commits -> versions 0..3
    write_watermark(ns, 0, Watermark(version=3, step=2))
    Reclaimer(ns, expected_ranks=1, physical_delete=False).run_cycle()
    info = inspect_run(ns)
    assert info["manifests"]["latest"] == 3
    assert info["view"]["total_steps"] == 4
    assert info["producers"]["P"]["committed_offset"] == 3
    assert info["producers"]["P"]["epoch"] == p.protocol.epoch
    assert info["watermarks"]["0"] == {"version": 3, "step": 2}
    assert info["trim"] == {"safe_step": 2, "safe_version": 3}
    assert info["tgb_objects"] == 4


def test_inspect_empty_namespace():
    info = inspect_run(Namespace(MemoryObjectStore(), "runs/job"))
    assert info["manifests"]["latest"] is None
    assert info["tgb_objects"] == 0


def test_inspect_run_equals_the_reference_on_a_mixed_run():
    """A TrainSession over a mix of a raw stream, a 2-shard stream folded by
    the compactor and a stream derived from the raw one, with an aligned
    checkpoint and a reclaim: both packages' ``inspect_run`` give one dict."""
    from repro_torch.core import Compactor, open_manifest_store

    store = MemoryObjectStore()
    grids = _fill_source(store, 6)
    ns = Namespace(store, NS)
    code = open_manifest_store(ns.stream("code"), shards=2)
    p = Producer(ns.stream("code"), "C", dp=DP, cp=1, manifests=code)
    p.recover()
    for g in grids:
        packed = GlobalBatchPacker(GB, SL, DP, 1).add_tokens(g.ravel())[0]
        p.write_tgb(slice_payloads=packed.slices,
                    num_samples=packed.num_samples,
                    token_count=packed.token_count)
        p.maybe_commit(force=True)
    p.finalize()
    DeriveWorker(ns, _graph(out_gb=GB, out_dp=DP), TOPO, window_steps=3).run(
        max_source_steps=6, timeout_s=5)
    train = TrainSession(store, TOPO, namespace=NS,
                         streams={"raw": 0.5, "code": 0.3, "filtered": 0.2})
    readers = [train.reader(dp_rank=d) for d in range(DP)]
    for _ in range(4):
        for r in readers:
            r.next_batch(timeout_s=5)
    train.checkpoint({"w": np.ones(3, np.float32)})
    train.reclaim()
    train.close()
    comp = Compactor(ns.stream("code"), open_manifest_store(ns.stream("code")),
                     min_fold=1)
    assert comp.run_cycle(safe_step=4)["folded"] > 0

    jcore, _, _, jops = _pkg("repro")
    ours = inspect_run(ns)
    ref = jops.inspect_run(jcore.Namespace(_view(store, jcore), NS))
    assert ours == ref
    assert ours["runmanifest"]["aligned"]["streams"] is not None
    assert ours["streams"]["code"]["manifests"]["sharded"]["segments"][
        "folded_steps"] > 0
    assert ours["streams"]["filtered"]["derive"]["cursor"]["src_step"] == 6
    # fsck: clean in the port; the reference reads the composite cursor of
    # the sharded stream against flat manifest versions, finds none and
    # calls it unreadable, its only issue
    assert fsck(ns).clean
    ref_issues = jops.fsck(jcore.Namespace(_view(store, jcore),
                                           NS)).all_issues()
    assert [(i.severity, i.kind) for i in ref_issues] == \
        [("error", "runmanifest-unreadable-cursor")]
    assert "'code'" in ref_issues[0].detail
