"""Twins of the tgb-facade cases of ``tests/test_elastic.py`` on the port.

``convert_logical_step`` and the tgb facade's factor DP resize: a resume at
2x or 1/2x the DP degree replays the byte-identical global batch sequence
(the per-rank payloads concatenated, as the reference compares them), a
misaligned or non-integer resize fails with the reference's messages, and a
hand-built token without a topology restores positionally. The reference's
sizes and ``match=`` strings throughout; the TrainSession, mixed-stream and
baseline cases of that file have their twins in ``tests/test_torch_run.py``,
``tests/test_torch_streams.py`` and ``tests/test_torch_baselines.py``.
"""
import pytest

pytest.importorskip("torch")

from repro_torch.core import MemoryObjectStore, convert_logical_step  # noqa: E402
from repro_torch.dataplane import Topology, open_dataplane  # noqa: E402
from repro_torch.dataplane.types import (Checkpoint,  # noqa: E402
                                         UnsupportedOperation)

NS = "runs/test_elastic"


def _fill(session, n, nbytes=192, stream=None):
    kw = {} if stream is None else {"stream": stream}
    with session.writer(f"P-{stream or 'single'}", **kw) as w:
        for _ in range(n):
            w.write(uniform_slice_bytes=nbytes)
        w.flush()


def _flat(readers, n_steps):
    """n_steps global batches as one concatenated byte string."""
    out = []
    for _ in range(n_steps):
        batches = [r.next_batch(timeout_s=10) for r in readers]
        assert len({b.step for b in batches}) == 1
        out.append(b"".join(b.payload for b in batches))
    return b"".join(out)


def test_convert_logical_step():
    assert convert_logical_step(6, 2, 4) == 3
    assert convert_logical_step(6, 2, 1) == 12
    assert convert_logical_step(0, 2, 4) == 0
    with pytest.raises(ValueError, match="integer factor"):
        convert_logical_step(6, 2, 3)
    with pytest.raises(ValueError, match="boundary"):
        convert_logical_step(5, 2, 4)  # 10 slices is not a dp=4 boundary


@pytest.mark.parametrize("new_dp", [4, 1])
def test_single_stream_resize_replays_identical_bytes(new_dp):
    store = MemoryObjectStore()
    topo = Topology(dp=2, cp=1)
    sess = open_dataplane(store, topo, backend="tgb", namespace=NS)
    _fill(sess, 12)
    readers = [sess.reader(dp_rank=d) for d in range(2)]
    _flat(readers, 6)
    token = readers[0].checkpoint().encode()
    baseline = _flat(readers, 6)            # un-resized continuation

    resized = open_dataplane(store, Topology(dp=new_dp, cp=1), backend="tgb",
                             namespace=NS, resume=token)
    new_readers = [resized.reader(dp_rank=d) for d in range(new_dp)]
    steps = 6 * 2 // new_dp
    assert _flat(new_readers, steps) == baseline


def test_resize_restore_requires_aligned_step():
    store = MemoryObjectStore()
    sess = open_dataplane(store, Topology(dp=2, cp=1), backend="tgb",
                          namespace=NS)
    _fill(sess, 8)
    r = sess.reader()
    for _ in range(3):
        r.next_batch(timeout_s=10)
    token = r.checkpoint()                   # step 3 @ dp=2: 6 slices
    grown = open_dataplane(store, Topology(dp=4, cp=1), backend="tgb",
                           namespace=NS)
    with pytest.raises(UnsupportedOperation, match="factor"):
        grown.reader().restore(token)        # 6 % 4 != 0: mid-batch


def test_resize_restore_rejects_non_integer_factor():
    store = MemoryObjectStore()
    sess = open_dataplane(store, Topology(dp=2, cp=1), backend="tgb",
                          namespace=NS)
    _fill(sess, 6)
    r = sess.reader()
    for _ in range(2):
        r.next_batch(timeout_s=10)
    token = r.checkpoint()
    odd = open_dataplane(store, Topology(dp=3, cp=1), backend="tgb",
                         namespace=NS)
    with pytest.raises(UnsupportedOperation, match="integer factor"):
        odd.reader().restore(token)


def test_hand_built_tokens_without_topology_restore_positionally():
    store = MemoryObjectStore()
    sess = open_dataplane(store, Topology(dp=1, cp=1), backend="tgb",
                          namespace=NS)
    _fill(sess, 4)
    r = sess.reader()
    first = [r.next_batch(timeout_s=10).payload for _ in range(4)]
    r2 = sess.reader()
    r2.restore(Checkpoint("tgb", version=r.checkpoint().version, step=2))
    assert [r2.next_batch(timeout_s=10).payload for _ in range(2)] == first[2:]
