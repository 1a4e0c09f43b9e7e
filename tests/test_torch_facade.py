"""Twin of the facade cases of ``tests/test_dataplane.py`` on the port:
``:77`` (the Checkpoint token's round trip), ``:112`` (a token of another
backend refused), ``:125`` and ``:161`` (the writer's crash recovery and its
exit on an exception), ``:277`` (a custom backend plugs in) and ``:323``
(topology validation), against ``repro_torch.dataplane``. The mq and
colocated cases of that file are twinned in
``tests/test_torch_baselines.py``. Imports neither jax nor msgpack.
"""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro_torch.core import (BatchTimeout, FaultInjector,  # noqa: E402
                              InjectedCrash, MemoryObjectStore)
from repro_torch.dataplane import (Batch, Checkpoint, Topology,  # noqa: E402
                                   UnsupportedOperation, open_dataplane,
                                   register_backend)

TOPO = Topology(dp=2, cp=2, global_batch=4, seq_len=16)


def _token_stream(n_batches: int, seed: int = 7) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 31_000, n_batches * TOPO.global_batch * TOPO.seq_len
                        ).astype(np.int32)


# ---------------------------------------------------------------------------
# Checkpoint: opaque token round-trip + resume
# ---------------------------------------------------------------------------

def test_checkpoint_token_roundtrip():
    ck = Checkpoint("tgb", version=12, step=34)
    assert Checkpoint.decode(ck.encode()) == ck
    assert Checkpoint.coerce(ck.encode()) == ck
    assert Checkpoint.coerce(None) is None
    with pytest.raises(ValueError):
        Checkpoint.decode("definitely-not-a-token")
    with pytest.raises(TypeError):
        Checkpoint.coerce(1234)


def test_checkpoint_backend_mismatch_rejected():
    ck = Checkpoint("mq", version=-1, step=3)
    with pytest.raises(ValueError, match="not portable"):
        open_dataplane(MemoryObjectStore(), TOPO, backend="tgb", resume=ck)
    session = open_dataplane(MemoryObjectStore(), TOPO, backend="tgb")
    with pytest.raises(ValueError, match="cannot restore"):
        session.reader().restore(ck)


# ---------------------------------------------------------------------------
# Writer lifecycle: crash mid-commit, recover exactly-once via context manager
# ---------------------------------------------------------------------------

def test_writer_crash_recovery_through_context_manager():
    store = MemoryObjectStore(faults=FaultInjector())
    session = open_dataplane(store, TOPO, backend="tgb", namespace="runs/cr")
    stream = _token_stream(8, seed=3)

    store.faults.crash_on("cput", key_substr=".manifest", nth=3)
    with pytest.raises(InjectedCrash):
        with session.writer("W") as w:
            for chunk in np.split(stream, 8):
                w.write_tokens(chunk)
                w.flush()
    store.faults = None

    # the crash left committed state behind; a replacement with the same id
    # recovers the durable offset on __enter__ and replays from 0 exactly-once
    with session.writer("W") as w2:
        assert w2.recovered_offset >= 1
        w2.seek(0)
        w2.write_tokens(stream)
        # __exit__ finalizes: drains everything not yet committed
    view = session.manifest_view()
    seqs = [t.producer_seq for t in view.tgbs]
    assert seqs == list(range(8)), seqs  # dense: no dups, no gaps

    # a clean exit after no writes must not commit anything new
    v_before = session.manifest_view().version
    with session.writer("W"):
        pass
    assert session.manifest_view().version == v_before

    # and the data is readable end to end
    r = session.reader(dp_rank=0, cp_rank=0)
    got = [r.next_batch(timeout_s=5).tokens for _ in range(8)]
    assert len(got) == 8


def test_writer_exit_propagates_body_exception_without_finalize():
    from repro_torch.core import FixedCountPolicy

    session = open_dataplane(MemoryObjectStore(), TOPO, backend="tgb")
    with pytest.raises(RuntimeError, match="boom"):
        # a never-firing cadence isolates the lifecycle behavior: the crash
        # must NOT trigger the finalize drain
        with session.writer("W", policy=FixedCountPolicy(100)) as w:
            w.write(uniform_slice_bytes=64)
            raise RuntimeError("boom")
    # the un-finalized TGB stays invisible (stage-1 write without commit)
    r = session.reader()
    with pytest.raises(BatchTimeout):
        r.next_batch(timeout_s=0.1)


# ---------------------------------------------------------------------------
# Registry: pluggable backends
# ---------------------------------------------------------------------------

def test_register_custom_backend_plugs_in():
    class EchoReader:
        def __init__(self, topo):
            self.topo, self.step = topo, 0

        def next_batch(self, timeout_s=None):
            b = Batch(payload=b"echo", step=self.step, version=-1,
                      dp_rank=0, cp_rank=0)
            self.step += 1
            return b

        def checkpoint(self):
            return Checkpoint("echo", -1, self.step)

        def restore(self, ck):
            self.step = Checkpoint.coerce(ck).step

        def close(self):
            pass

    class EchoSession:
        backend = "echo"

        def __init__(self, target, topology, **opts):
            self.topology = topology

        def reader(self, dp_rank=0, cp_rank=0, **opts):
            return EchoReader(self.topology)

        def writer(self, writer_id="w0", **opts):
            raise UnsupportedOperation("read-only backend")

        def close(self):
            pass

    register_backend("echo", EchoSession, overwrite=True)
    s = open_dataplane(None, TOPO, backend="echo")
    assert s.reader().next_batch().payload == b"echo"
    with pytest.raises(ValueError):
        register_backend("echo", EchoSession)  # no silent clobber

    ck = s.reader().checkpoint()
    s2 = open_dataplane(None, TOPO, backend="echo", resume=ck)
    assert isinstance(s2.reader().next_batch(), Batch)


def test_topology_validation():
    with pytest.raises(ValueError):
        Topology(dp=0)
    with pytest.raises(ValueError):
        Topology(dp=3, global_batch=4, seq_len=8)
    with pytest.raises(ValueError):
        Topology(dp=2, cp=3, global_batch=4, seq_len=8)
    t = Topology(dp=2, cp=2, global_batch=8, seq_len=64)
    assert (t.world, t.samples_per_slice, t.seq_per_rank) == (4, 4, 32)
    assert not Topology(dp=2).decodable
