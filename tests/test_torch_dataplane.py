"""The port's tgb data plane against the JAX package's, on one object store.

A store written by either package reads back identically in the other:
every (d, c) reader yields the same ``Batch`` fields (step, tokens) and the
same Checkpoint tokens, and a token minted by one package restores a reader
of the other. The facade's adversarial probes raise the same typed errors as
in ``repro``. The mq and colocated baselines open and match the reference,
and the ``resilience=`` and ``obs_snap_interval_s=`` options write what the
reference reads back (the baselines' own twins are in
``tests/test_torch_baselines.py``).

Each package's session refuses a store that is not its own
``ObjectStore``, so "one store" is two ``MemoryObjectStore`` objects, one of
each package, over the same key -> bytes map and lock (``_view``).
"""
import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")
pytest.importorskip("msgpack")

import repro.core as jcore  # noqa: E402
import repro.data as jdata  # noqa: E402
import repro.dataplane as jdp  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.data as tdata  # noqa: E402
import repro_torch.dataplane as tdp  # noqa: E402

TOPO_ARGS = dict(dp=2, cp=2, global_batch=4, seq_len=16)
N_BATCHES = 5
NS = "runs/xframe"


def _stream(n_batches: int = N_BATCHES, vocab: int = 1000) -> np.ndarray:
    n = n_batches * TOPO_ARGS["global_batch"] * TOPO_ARGS["seq_len"]
    return ((np.arange(n) * 7 + 3) % vocab).astype(np.int32)


def _write(pkg, core, tokens) -> object:
    """One store holding ``tokens`` written by ``pkg``'s tgb writer."""
    store = core.MemoryObjectStore()
    sess = pkg.open_dataplane(store, pkg.Topology(**TOPO_ARGS),
                              namespace=NS)
    with sess.writer("w0") as w:
        w.write_tokens(tokens)
    sess.close()
    return store


def _read_all(pkg, store, n_steps: int, resume=None):
    """{(d, c): [(step, dtype, shape, tokens bytes, token after), ...]}."""
    sess = pkg.open_dataplane(_view(store, pkg), pkg.Topology(**TOPO_ARGS),
                              namespace=NS, resume=resume)
    out = {}
    for d in range(TOPO_ARGS["dp"]):
        for c in range(TOPO_ARGS["cp"]):
            r = sess.reader(dp_rank=d, cp_rank=c)
            rows = []
            for _ in range(n_steps):
                b = r.next_batch(timeout_s=5)
                rows.append((b.step, b.tokens.dtype.str, b.tokens.shape,
                             b.tokens.tobytes(), r.checkpoint().encode()))
            out[(d, c)] = rows
    sess.close()
    return out


WRITERS = {"repro": (jdp, jcore), "repro_torch": (tdp, tcore)}
CORE = {jdp: jcore, tdp: tcore}


def _view(store, pkg):
    """``pkg``'s MemoryObjectStore over ``store``'s objects."""
    twin = CORE[pkg].MemoryObjectStore()
    twin._objects, twin._lock = store._objects, store._lock
    return twin


@pytest.mark.parametrize("writer", ["repro", "repro_torch"])
def test_readers_of_both_packages_agree_on_either_writers_store(writer):
    store = _write(*WRITERS[writer], _stream())
    jax_rows = _read_all(jdp, store, N_BATCHES)
    torch_rows = _read_all(tdp, store, N_BATCHES)
    assert torch_rows == jax_rows
    # and the tokens are the stream, sliced at (d, c)
    full = _stream().reshape(N_BATCHES, TOPO_ARGS["global_batch"],
                             TOPO_ARGS["seq_len"])
    (step, _, shape, raw, _) = torch_rows[(1, 1)][2]
    got = np.frombuffer(raw, np.int32).reshape(shape)
    np.testing.assert_array_equal(got, full[step, 2:, 8:])


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_checkpoint_token_restores_a_reader_of_the_other_package(direction):
    src, dst = (jdp, tdp) if direction == "jax_to_torch" else (tdp, jdp)
    store = _write(jdp, jcore, _stream())
    sess = src.open_dataplane(_view(store, src), src.Topology(**TOPO_ARGS),
                              namespace=NS)
    r = sess.reader(dp_rank=1, cp_rank=0)
    r.next_batch(timeout_s=5)
    r.next_batch(timeout_s=5)
    token = r.checkpoint().encode()
    want = r.next_batch(timeout_s=5)
    token_after = r.checkpoint().encode()
    sess.close()
    # the token as a session-wide resume= and as a reader.restore
    resumed = _read_all(dst, store, 1, resume=token)
    assert resumed[(1, 0)][0][0] == want.step == 2
    assert resumed[(1, 0)][0][3] == want.tokens.tobytes()
    sess2 = dst.open_dataplane(_view(store, dst), dst.Topology(**TOPO_ARGS),
                               namespace=NS)
    r2 = sess2.reader(dp_rank=1, cp_rank=0)
    r2.restore(token)
    b = r2.next_batch(timeout_s=5)
    assert (b.step, b.tokens.tobytes()) == (want.step, want.tokens.tobytes())
    assert r2.checkpoint().encode() == token_after
    sess2.close()


# ---------------------------------------------------------------------------
# Facade probes: the same typed errors as the reference
# ---------------------------------------------------------------------------

def _probe(pkg, core, name):
    store = core.MemoryObjectStore()
    topo = pkg.Topology(**TOPO_ARGS)
    if name == "garbage_resume":
        pkg.open_dataplane(store, topo, namespace=NS, resume="not-a-token!!")
    elif name == "unknown_backend":
        pkg.open_dataplane(store, topo, backend="carrier-pigeon",
                           namespace=NS)
    elif name == "write_tokens_non_decodable":
        sess = pkg.open_dataplane(store, pkg.Topology(dp=2, cp=1),
                                  namespace=NS)
        with sess.writer("w0") as w:
            w.write_tokens(np.arange(10, dtype=np.int32))
    elif name == "empty_namespace_timeout":
        sess = pkg.open_dataplane(store, topo, namespace="runs/empty")
        sess.reader(dp_rank=0).next_batch(timeout_s=0.1)
    elif name == "wrong_target_type":
        pkg.open_dataplane(object(), topo, namespace=NS)
    elif name == "cross_backend_token":
        tok = pkg.Checkpoint("mq", version=0, step=0).encode()
        pkg.open_dataplane(store, topo, namespace=NS, resume=tok)


PROBES = ["garbage_resume", "unknown_backend", "write_tokens_non_decodable",
          "empty_namespace_timeout", "wrong_target_type",
          "cross_backend_token"]


@pytest.mark.parametrize("probe", PROBES)
def test_facade_probes_raise_the_reference_errors(probe):
    with pytest.raises(Exception) as jax_err:
        _probe(jdp, jcore, probe)
    with pytest.raises(Exception) as torch_err:
        _probe(tdp, tcore, probe)
    # same error class name (the packages' classes are distinct objects)
    assert type(torch_err.value).__name__ == type(jax_err.value).__name__
    assert type(torch_err.value).__name__ in (
        "ValueError", "UnsupportedOperation", "BatchTimeout", "TypeError")


@pytest.mark.parametrize("backend", ["mq", "colocated"])
def test_baseline_backends_open_and_match_the_reference(backend):
    """Both packages register the reference's three backends, and a
    baseline session of each gives the same batches and tokens (one
    colocated worker, so its indices come in order)."""
    # other tests in a worker may register more (``echo``); the built-ins
    # are the reference's three
    built_in = {"colocated", "mq", "tgb"}
    assert built_in <= set(tdp.available_backends())
    assert built_in <= set(jdp.available_backends())

    def run(pkg):
        if backend == "mq":
            sess = pkg.open_dataplane(None, pkg.Topology(**TOPO_ARGS),
                                      backend="mq")
            with sess.writer("w0") as w:
                w.write_tokens(_stream())
        else:
            data = tdata if pkg is tdp else jdata
            sess = pkg.open_dataplane(
                None, pkg.Topology(dp=2), backend="colocated",
                config=data.ColocatedConfig(workers=1), batch_cpu_items=4)
            sess.writer().__enter__()
        r = sess.reader(dp_rank=1, cp_rank=0)
        rows = []
        for _ in range(3):
            b = r.next_batch(timeout_s=5)
            rows.append((b.step, b.version, b.payload,
                         r.checkpoint().encode()))
        sess.close()
        return rows
    assert run(tdp) == run(jdp)


def test_resilience_option_reads_back_in_the_reference():
    """``resilience=True``: the port's clients write through one shared
    ``ResilientStore``; the reference reads the store they wrote."""
    store = tcore.MemoryObjectStore()
    sess = tdp.open_dataplane(store, tdp.Topology(**TOPO_ARGS), namespace=NS,
                              resilience=True)
    assert isinstance(sess.store, tcore.ResilientStore)
    assert sess.store.inner is store
    with sess.writer("w0") as w:
        w.write_tokens(_stream())
    ours = {(d, c): [sess.reader(dp_rank=d, cp_rank=c).next_batch(
        timeout_s=5).tokens.tobytes()] for d in range(2) for c in range(2)}
    sess.close()
    assert _read_all(jdp, store, N_BATCHES) == _read_all(tdp, store,
                                                         N_BATCHES)
    theirs = _read_all(jdp, store, 1)
    assert {dc: [row[3] for row in rows] for dc, rows in theirs.items()} \
        == ours


def test_flight_recorder_option_publishes_what_the_reference_reads():
    """``obs_snap_interval_s``: the port's writer and readers publish
    snapshot chains the reference's recorder reads back."""
    from repro.obs.recorder import component_dirs, latest_snapshot
    store = tcore.MemoryObjectStore()
    sess = tdp.open_dataplane(store, tdp.Topology(**TOPO_ARGS),
                              namespace=NS, obs_snap_interval_s=0.0)
    with sess.writer("w0") as w:
        w.write_tokens(_stream())
        prod = w.stats.metric_scope   # "producer.w0", suffixed on reuse
    r = sess.reader(dp_rank=0, cp_rank=1)
    for _ in range(2):
        r.next_batch(timeout_s=5)
    cons = r.stats.metric_scope
    sess.close()
    jns = jcore.Namespace(_view(store, jdp), NS)
    assert component_dirs(jns) == sorted([cons, prod])
    assert latest_snapshot(jns, cons)["metrics"][
        f"{cons}.steps_consumed"] == 2
    assert latest_snapshot(jns, prod)["metrics"][
        f"{prod}.tgbs_written"] == N_BATCHES


def test_watermarks_and_reclaim_interoperate():
    """Port readers save watermarks, the JAX reclaimer trims below them, and
    a port reader resumes past the trim from its token."""
    store = _write(tdp, tcore, _stream())
    tsess = tdp.open_dataplane(store, tdp.Topology(**TOPO_ARGS), namespace=NS)
    tokens = []
    for rank, (d, c) in enumerate([(0, 0), (0, 1), (1, 0), (1, 1)]):
        r = tsess.reader(dp_rank=d, cp_rank=c)
        for _ in range(3):
            r.next_batch(timeout_s=5)
        tsess.save_watermark(rank, r.checkpoint())
        tokens.append(r.checkpoint().encode())
    jsess = jdp.open_dataplane(_view(store, jdp), jdp.Topology(**TOPO_ARGS),
                               namespace=NS)
    assert jsess.reclaim() == 3        # TGBs of steps 0-2 deleted
    assert tsess.reclaim_stats.tgbs_deleted == 0
    tsess.reclaim()                    # idempotent from the port's side
    r = tdp.open_dataplane(store, tdp.Topology(**TOPO_ARGS), namespace=NS,
                           resume=tokens[0]).reader(dp_rank=0)
    assert r.next_batch(timeout_s=5).step == 3
