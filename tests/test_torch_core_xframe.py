"""The data plane's store objects, the same in both packages.

For each family of the data-plane twins that writes to the store, the same
seeded inputs go through ``repro`` and ``repro_torch`` and every object
each writes is compared byte for byte: TGB bodies and footers (``core/tgb``),
manifest versions in the flat and the delta format with a rebase and a trim
(``core/manifest``, ``CommitProtocol``), watermarks and the trim marker
after a reclaim (``core/lifecycle``), the packer's grids
(``data/packing``), and a ``PreprocessWorker`` run with a legacy
checkpoint (the system test's path). Each package then reads the other's
store: the same views, cursors and batches, off a ``MemoryObjectStore``
and off one ``FileObjectStore`` root, and through the I/O path's pipelined
commits, parallel prefetch and coalesced reads. DAC: one seeded
commit-outcome trace gives the same decisions and gaps in both packages'
policies, and the reference test's discrete-event simulation the same
counts. The facade-level reads (``open_dataplane``) are in
``tests/test_torch_dataplane.py``.

Object keys hold a random token (``Producer.write_tgb``'s ``uuid4``); each
run draws it from one seeded generator, so both packages name their
objects alike.
"""
import random
import uuid

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")
pytest.importorskip("msgpack")

import repro.core as jcore  # noqa: E402
import repro.data as jdata  # noqa: E402
import repro.train.checkpoint as jckpt  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.data as tdata  # noqa: E402
import repro_torch.train.checkpoint as tckpt  # noqa: E402
from test_torch_dac_simulation import simulate  # noqa: E402

CORES = {"repro": jcore, "repro_torch": tcore}
DATA = {"repro": jdata, "repro_torch": tdata}
CKPT = {"repro": jckpt, "repro_torch": tckpt}
NS = "runs/xframe"


def _seed_keys(monkeypatch, seed: int = 0) -> None:
    """Draw ``uuid.uuid4`` from a generator seeded ``seed``."""
    rng = random.Random(seed)
    monkeypatch.setattr(uuid, "uuid4",
                        lambda: uuid.UUID(int=rng.getrandbits(128)))


def _objects(store) -> dict:
    return {k: store.get(k) for k in store.list("")}


def _view(store, core):
    """``core``'s MemoryObjectStore over ``store``'s objects."""
    twin = core.MemoryObjectStore()
    twin._objects, twin._lock = store._objects, store._lock
    return twin


def _payloads(rng, dp: int, cp: int, max_bytes: int = 512) -> dict:
    return {(d, c): rng.integers(0, 256, int(rng.integers(0, max_bytes + 1)),
                                 dtype=np.uint8).tobytes()
            for d in range(dp) for c in range(cp)}


def _view_summary(view) -> tuple:
    """A manifest view as plain values, comparable across packages."""
    return (view.version, view.base_step, view.total_steps,
            [(t.tgb_id, t.object_key, t.size_bytes, t.dp, t.cp,
              t.num_samples, t.token_count, t.producer_id, t.producer_seq)
             for t in view.tgbs],
            {pid: view.producer_offset(pid) for pid in sorted(view.producers)})


# ---------------------------------------------------------------------------
# TGB bodies and footers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_tgb_bodies_and_footers_are_byte_identical(seed):
    rng = np.random.default_rng(seed)
    dp, cp = int(rng.integers(1, 5)), int(rng.integers(1, 4))
    payloads = _payloads(rng, dp, cp)
    provenance = ({"src_stream": "raw", "op_chain": ["filter"], "out": seed}
                  if seed % 2 else None)

    def build(core):
        b = core.TGBBuilder(f"t{seed}", dp=dp, cp=cp, producer_id="p",
                            producer_seq=seed, num_samples=3 * seed,
                            token_count=17 * seed, provenance=provenance)
        for (d, c), payload in payloads.items():
            b.add_slice(d, c, payload)
        return [b.build(), core.tgb.build_uniform_tgb(
            f"u{seed}", dp, cp, "p", seed, 64 * (seed + 1), num_samples=seed,
            token_count=5)]

    blobs = build(jcore)
    assert build(tcore) == blobs
    for blob, want in zip(blobs, (payloads, None)):
        footers = {}
        for name, core in CORES.items():
            store = core.MemoryObjectStore()
            store.put("k", blob)
            r = core.TGBReader(store, "k")
            footers[name] = r.footer().to_bytes()
            got = {(d, c): r.read_slice(d, c)
                   for d in range(dp) for c in range(cp)}
            if want is not None:
                assert got == want
            assert b"".join(got.values()) == blob[:sum(map(len, got.values()))]
        assert footers["repro_torch"] == footers["repro"]


# ---------------------------------------------------------------------------
# Manifest versions, flat and delta: two producers racing, then a trim
# ---------------------------------------------------------------------------

def _manifest_run(core, fmt: str) -> object:
    store = core.MemoryObjectStore()
    ns = core.Namespace(store, NS)
    rng = np.random.default_rng(3)
    fmt = {"flat": core.MANIFEST_FORMAT_FLAT,
           "delta": core.MANIFEST_FORMAT_DELTA}[fmt]
    prods = [core.Producer(ns, f"p{i}", dp=2, cp=1,
                           policy=core.NaivePolicy(),
                           manifests=core.ManifestStore(
                               ns, fmt=fmt, snapshot_every=3))
             for i in range(2)]
    for _ in range(7):
        for p in prods:   # p1 commits on a stale view: a rebase each time
            p.write_tgb(slice_payloads=_payloads(rng, 2, 1), num_samples=2,
                        token_count=int(rng.integers(1, 64)))
            p.maybe_commit(force=True)
    prods[0].write_tgb(slice_payloads=_payloads(rng, 2, 1))
    prods[0].maybe_commit(trim_to_step=4, force=True)
    for p in prods:
        p.finalize()
    return store


@pytest.mark.parametrize("fmt", ["flat", "delta"])
def test_manifest_versions_are_byte_identical(monkeypatch, fmt):
    stores = {}
    for name, core in CORES.items():
        _seed_keys(monkeypatch)
        stores[name] = _manifest_run(core, fmt)
    objects = _objects(stores["repro"])
    assert _objects(stores["repro_torch"]) == objects
    n_versions = sum(k.endswith(".manifest") for k in objects)
    assert n_versions >= 15
    # each package reads the other's chain, cold and (flat) incrementally
    for writer, store in stores.items():
        summaries = []
        for name, core in CORES.items():
            ns = core.Namespace(_view(store, core), NS)
            ms = core.ManifestStore(ns)
            latest = ms.latest_version()
            cold = ms.load_view(latest)
            warm = ms.load_view(latest, base=ms.load_view(latest - 3))
            assert _view_summary(warm) == _view_summary(cold)
            summaries.append((latest, _view_summary(cold)))
        assert summaries[0] == summaries[1]
        (latest, (_, base_step, total, tgbs, offsets)) = summaries[0]
        assert latest == n_versions - 1
        assert (base_step, total, offsets) == (4, 15, {"p0": 7, "p1": 6})
        assert len(tgbs) == 11


# ---------------------------------------------------------------------------
# Watermarks and the trim marker
# ---------------------------------------------------------------------------

def _lifecycle_run(core) -> object:
    store = core.MemoryObjectStore()
    ns = core.Namespace(store, NS)
    rng = np.random.default_rng(5)
    p = core.Producer(ns, "p0", dp=2, cp=1, manifests=core.ManifestStore(ns))
    for _ in range(10):
        p.write_tgb(slice_payloads=_payloads(rng, 2, 1))
        p.maybe_commit(force=True)
    core.write_watermark(ns, 0, core.Watermark(version=9, step=6))
    core.write_watermark(ns, 1, core.Watermark(version=8, step=7))
    r = core.Reclaimer(ns, expected_ranks=2)
    assert r.run_cycle() == core.Watermark(version=8, step=6)
    assert r.stats.tgbs_deleted == 6
    safe_step, _ = r.read_trim()
    p.write_tgb(slice_payloads=_payloads(rng, 2, 1))
    p.maybe_commit(trim_to_step=safe_step, force=True)
    p.finalize()
    return store


def test_watermark_and_trim_objects_are_byte_identical(monkeypatch):
    stores = {}
    for name, core in CORES.items():
        _seed_keys(monkeypatch)
        stores[name] = _lifecycle_run(core)
    objects = _objects(stores["repro"])
    assert _objects(stores["repro_torch"]) == objects
    assert sum(k.endswith(".wm") for k in objects) == 2
    assert sum(k.endswith("trim.marker") for k in objects) == 1
    for writer, store in stores.items():
        seen = []
        for name, core in CORES.items():
            ns = core.Namespace(_view(store, core), NS)
            wm = core.global_watermark(ns, expected_ranks=2)
            view = core.ManifestStore(ns).load_view(
                core.ManifestStore(ns).latest_version())
            cons = core.Consumer(ns, core.MeshPosition(1, 0, 2, 1))
            cons.restore_cursor(wm.version, wm.step)
            batches = [cons.next_batch(1.0) for _ in range(5)]
            seen.append(((wm.version, wm.step), core.read_trim_marker(ns),
                         view.base_step, batches))
        assert seen[0] == seen[1]
        assert seen[0][1][0] == seen[0][2] == 6


# ---------------------------------------------------------------------------
# Each package reads the other's store: memory and file backends
# ---------------------------------------------------------------------------

def _store(core, backend, tmp_path):
    if backend == "memory":
        return core.MemoryObjectStore()
    return core.FileObjectStore(str(tmp_path / "store"))


@pytest.mark.parametrize("backend", ["memory", "file"])
@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
def test_each_package_reads_the_others_store_to_the_same_batches(
        tmp_path, writer, backend):
    core = CORES[writer]
    store = _store(core, backend, tmp_path)
    ns = core.Namespace(store, NS)
    rng = np.random.default_rng(7)
    p = core.Producer(ns, "w0", dp=2, cp=2, manifests=core.ManifestStore(ns))
    written = []
    for _ in range(6):
        written.append(_payloads(rng, 2, 2, max_bytes=2048))
        p.write_tgb(slice_payloads=written[-1])
        p.maybe_commit(force=True)
    p.finalize()
    objects = _objects(store)
    for name, rcore in CORES.items():
        rstore = (_view(store, rcore) if backend == "memory"
                  else rcore.FileObjectStore(str(tmp_path / "store")))
        assert _objects(rstore) == objects
        rns = rcore.Namespace(rstore, NS)
        for d in range(2):
            for c in range(2):
                cons = rcore.Consumer(rns, rcore.MeshPosition(d, c, 2, 2))
                assert [cons.next_batch(1.0) for _ in range(6)] == \
                    [w[(d, c)] for w in written]
                assert cons.cursor[1] == 6


# ---------------------------------------------------------------------------
# The I/O path: pipelined commits, parallel prefetch, coalesced reads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
def test_pipelined_store_reads_alike_through_either_io_path(writer):
    core = CORES[writer]
    store = core.MemoryObjectStore()
    ns = core.Namespace(store, NS)
    rng = np.random.default_rng(11)
    pool = core.IOPool(max_workers=2, name="xframe-commit")
    written = []
    try:
        p = core.Producer(ns, "p0", dp=2, cp=4, policy=core.NaivePolicy(),
                          manifests=core.ManifestStore(ns),
                          pipeline_commits=True, io_pool=pool)
        for _ in range(8):
            written.append(_payloads(rng, 2, 4))
            p.write_tgb(slice_payloads=written[-1])
            p.maybe_commit()
        p.finalize()
    finally:
        pool.shutdown()
    for name, rcore in CORES.items():
        rns = rcore.Namespace(_view(store, rcore), NS)
        pool = rcore.IOPool(max_workers=4, name="xframe-io")
        try:
            fast = rcore.Consumer(rns, rcore.MeshPosition(0, 1, 2, 2),
                                  io_pool=pool, prefetch_depth=4)
            fast.poll()
            fast.start_prefetch()
            try:
                got = [fast.next_batch(5.0) for _ in range(8)]
            finally:
                fast.stop_prefetch()
        finally:
            pool.shutdown()
        slow = rcore.Consumer(rns, rcore.MeshPosition(0, 1, 2, 2),
                              parallel_prefetch=False, coalesce_reads=False,
                              speculative_tail=0)
        slow.poll()   # see test_a_fresh_consumer_remaps_... for why
        want = [w[(0, 2)] + w[(0, 3)] for w in written]
        assert got == want
        assert [slow.next_batch(5.0) for _ in range(8)] == want


# ---------------------------------------------------------------------------
# The packer's grids
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_packer_grids_are_identical(seed):
    rng = np.random.default_rng(seed)
    dp, cp = int(rng.choice([1, 2, 4])), int(rng.choice([1, 2]))
    gb, seq = dp * int(rng.integers(1, 4)), cp * int(rng.integers(1, 6))
    chunks = [(rng.integers(0, 50_000, int(n)).astype(np.int32),
               int(rng.integers(0, 4)))
              for n in rng.integers(1, 97, int(rng.integers(5, 30)))]
    pad = int(rng.choice([0, 7, -1]))
    runs = {}
    for name, data in DATA.items():
        packer = data.GlobalBatchPacker(gb, seq, dp=dp, cp=cp)
        out = []
        for toks, samples in chunks:
            out.extend(packer.add_tokens(toks, samples=samples))
        tail = packer.flush(pad_token=pad)
        out += [tail] if tail is not None else []
        runs[name] = [
            (sorted(b.slices.items()), b.token_count, b.num_samples,
             data.packing.assemble_grid(b.slices, gb, seq, dp, cp).tobytes())
            for b in out]
    assert runs["repro_torch"] == runs["repro"]
    assert runs["repro"]


# ---------------------------------------------------------------------------
# The system test's path: PreprocessWorker TGBs and a legacy checkpoint
# ---------------------------------------------------------------------------

def _system_run(name):
    core, data, ckpt = CORES[name], DATA[name], CKPT[name]
    store = core.MemoryObjectStore()
    ns = core.Namespace(store, NS)
    # NaivePolicy: a commit per TGB (DAC's cadence follows the wall clock)
    prod = core.Producer(ns, "w0", dp=2, cp=1, policy=core.NaivePolicy(),
                         manifests=core.ManifestStore(ns))
    pc = data.PipelineConfig(global_batch=4, seq_len=32, dp=2, cp=1,
                             vocab_size=257, seed=11)
    data.PreprocessWorker(pc, data.PreprocessConfig(), prod).produce_n_tgbs(8)
    prod.finalize()
    cons = core.Consumer(ns, core.MeshPosition(0, 0, 2, 1))
    for _ in range(4):
        cons.next_batch(2.0)
    ckpt.save_checkpoint(ns, step=4, state={"w": np.arange(6, dtype=np.float32),
                                            "step": np.int32(4)},
                         cursor=cons.cursor, consumer_ranks=[0, 1])
    core.Reclaimer(ns, expected_ranks=2).run_cycle()
    return store


def test_preprocess_worker_and_legacy_checkpoint_objects_are_identical(
        monkeypatch):
    stores = {}
    for name in CORES:
        _seed_keys(monkeypatch)
        stores[name] = _system_run(name)
    objects = _objects(stores["repro"])
    assert _objects(stores["repro_torch"]) == objects
    assert any(k.endswith("MANIFEST.ckpt") for k in objects)
    for writer, store in stores.items():
        seen = []
        for name, core in CORES.items():
            ns = core.Namespace(_view(store, core), NS)
            template = {"w": np.zeros(6, np.float32), "step": np.int32(0)}
            state, cursor, step = CKPT[name].restore_checkpoint(ns, template)
            cons = core.Consumer(ns, core.MeshPosition(1, 0, 2, 1))
            cons.restore_cursor(*cursor)
            seen.append((np.asarray(state["w"]).tobytes(),
                         int(state["step"]), cursor, step,
                         [cons.next_batch(2.0) for _ in range(4)]))
        assert seen[0] == seen[1]
        assert seen[0][2][1] == seen[0][3] == 4


# ---------------------------------------------------------------------------
# DAC and the baseline policies: one outcome trace, the same decisions
# ---------------------------------------------------------------------------

def _trace(seed: int = 0, n: int = 300):
    rng = np.random.default_rng(seed)
    now, out = 0.0, []
    for _ in range(n):
        now += float(rng.exponential(0.2))
        out.append((bool(rng.random() > 0.25), float(rng.lognormal(-3, 0.7)),
                    int(rng.integers(1, 33)), now, int(rng.integers(0, 12))))
    return out


POLICIES = {
    "dac": lambda core: core.DACPolicy(core.DACConfig(eps=0.05, delta=0.3,
                                                      alpha=0.3, rho=0.2,
                                                      seed=5)),
    "aimd": lambda core: core.AIMDPolicy(),
    "fixed": lambda core: core.FixedCountPolicy(4),
    "incr": lambda core: core.IncrPolicy(k0=2),
    "naive": lambda core: core.NaivePolicy(),
}


def _state(policy) -> dict:
    return {k: v for k, v in vars(policy).items()
            if isinstance(v, (bool, int, float))}


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_policies_give_the_same_gaps_on_one_outcome_trace(policy):
    runs = {}
    for name, core in CORES.items():
        p = POLICIES[policy](core)
        rows = []
        for ok, tau, n, now, pending in _trace():
            rows.append(p.should_attempt(pending, now))
            p.on_outcome(ok, tau, n, now=now)
            rows.append(_state(p))
        runs[name] = rows
    assert runs["repro_torch"] == runs["repro"]
    if policy == "dac":
        gaps = [r["gap"] for r in runs["repro"][1::2]]
        assert len(set(gaps)) > 100   # the jittered gap moves every outcome
    if policy == "aimd":
        assert len({r["T"] for r in runs["repro"][1::2]}) > 10


def test_shard_chooser_moves_alike_on_one_conflict_trace():
    rng = np.random.default_rng(2)
    outcomes = rng.random(400) > 0.4
    loads = rng.integers(0, 50, (400, 4))
    runs = {}
    for name, core in CORES.items():
        ch = core.ShardChooser(4, "p7")
        rows = []
        for ok, load in zip(outcomes, loads):
            ch.observe(bool(ok))
            if ch.should_probe():
                ch.move_to(ch.choose([int(x) for x in load]))
            rows.append((ch.shard, ch.conflict_ema))
        runs[name] = rows
    assert runs["repro_torch"] == runs["repro"]
    assert len({s for s, _ in runs["repro"]}) > 1


@pytest.mark.parametrize("policy", ["dac", "fixed"])
def test_dac_simulation_counts_are_identical(policy):
    """The discrete-event simulation of ``tests/test_dac_simulation.py``
    (its twin's copy) with each package's policies: the same attempts and
    conflicts, which the closed loop would amplify from any difference."""
    counts = {}
    for name, core in CORES.items():
        if policy == "dac":
            def factory(i, core=core):
                return core.DACPolicy(core.DACConfig(eps=0.05, delta=0.5,
                                                     alpha=0.3, rho=0.2,
                                                     seed=i))
        else:
            def factory(i, core=core):
                return core.FixedCountPolicy(1)
        counts[name] = simulate(8, tau=0.05, eps=0.05, policy_factory=factory)
    assert counts["repro_torch"] == counts["repro"]


# ---------------------------------------------------------------------------
# The port departs from a fault of the reference (ROADMAP Queue 3)
# ---------------------------------------------------------------------------

def _layout_run(core, dp: int, cp: int, pos: tuple) -> list:
    """Slices are one byte, 64 * step + 8 * d + c; a fresh consumer at
    ``pos`` reads 2 steps without polling first."""
    ns = core.Namespace(core.MemoryObjectStore(), NS)
    p = core.Producer(ns, "p0", dp=dp, cp=cp, policy=core.NaivePolicy(),
                      manifests=core.ManifestStore(ns))
    for s in range(4):
        p.write_tgb(slice_payloads={(d, c): bytes([64 * s + 8 * d + c])
                                    for d in range(dp) for c in range(cp)})
        p.maybe_commit()
    p.finalize()
    cons = core.Consumer(ns, core.MeshPosition(*pos))
    try:
        return [list(cons.next_batch(1.0)) for _ in range(2)]
    except IndexError as e:
        return [type(e).__name__]


@pytest.mark.parametrize("dp,cp,pos,want,reference", [
    # CP shrink 4 -> 2: rank c 1 owns chunks 2-3; the reference's first
    # step reads 1-2, overlapping rank 0's
    (2, 4, (0, 1, 2, 2), [[2, 3], [66, 67]], [[1, 2], [66, 67]]),
    # DP growth 1 -> 2 and 2 -> 4: the reference asks for a slice the TGB
    # does not have
    (1, 1, (1, 0, 2, 1), [[64], [192]], ["IndexError"]),
    (2, 1, (3, 0, 4, 1), [[72], [200]], ["IndexError"]),
], ids=["cp4-to-2", "dp1-to-2", "dp2-to-4"])
def test_a_fresh_consumer_remaps_its_first_step_against_the_tgb_layout(
        dp, cp, pos, want, reference):
    """``Consumer.next_batch`` remaps a step with ``remap_step`` against the
    TGBs' D x C; before its first view it has none and takes its own
    topology's. The reference remaps step 0 so (its later steps are right);
    the port remaps again once the wait has loaded the view."""
    assert _layout_run(tcore, dp, cp, pos) == want
    assert _layout_run(jcore, dp, cp, pos) == reference
