"""Twin of ``tests/test_tgb.py`` on the port: the TGB layout's build/read
round trip, footer index, crc and properties, against ``repro_torch.core``.
Imports neither jax nor msgpack (the card's machine has neither); the
cross-package cases are in ``tests/test_torch_core_xframe.py``.
"""
import pytest
from hypothesis import given, settings, strategies as st

pytest.importorskip("torch")

from repro_torch.core import (MemoryObjectStore, TGBBuilder,  # noqa: E402
                              TGBReader)
from repro_torch.core.tgb import (TGBFormatError,  # noqa: E402
                                  build_uniform_tgb)


@pytest.fixture
def store():
    """The port's store (shadows the reference's in conftest)."""
    return MemoryObjectStore()


def _put(store, blob, key="t/x.tgb"):
    store.put(key, blob)
    return key


def test_roundtrip_all_slices(store):
    b = TGBBuilder("t0", dp=2, cp=2, producer_id="p", producer_seq=0)
    payloads = {}
    for d in range(2):
        for c in range(2):
            payloads[(d, c)] = f"slice-{d}-{c}".encode() * (d + c + 1)
            b.add_slice(d, c, payloads[(d, c)])
    key = _put(store, b.build())
    r = TGBReader(store, key)
    f = r.footer()
    assert (f.dp, f.cp) == (2, 2)
    for (d, c), want in payloads.items():
        assert r.read_slice(d, c) == want


def test_incomplete_tgb_rejected():
    b = TGBBuilder("t0", dp=2, cp=1, producer_id="p", producer_seq=0)
    b.add_slice(0, 0, b"x")
    with pytest.raises(TGBFormatError):
        b.build()


def test_duplicate_slice_rejected():
    b = TGBBuilder("t0", dp=1, cp=1, producer_id="p", producer_seq=0)
    b.add_slice(0, 0, b"x")
    with pytest.raises(ValueError):
        b.add_slice(0, 0, b"y")


def test_crc_detects_corruption(store):
    blob = bytearray(build_uniform_tgb("t", 1, 1, "p", 0, 64))
    blob[3] ^= 0xFF  # corrupt payload byte
    key = _put(store, bytes(blob))
    r = TGBReader(store, key)
    with pytest.raises(TGBFormatError):
        r.read_slice(0, 0)
    assert r.read_slice(0, 0, verify=False)  # readable without verification


def test_footer_cache_avoids_rereads(store):
    key = _put(store, build_uniform_tgb("t", 2, 1, "p", 0, 128))
    r = TGBReader(store, key)
    r.footer()
    gets_before = store.stats.range_gets
    r.footer()
    r.read_slice(0, 0)
    # small TGB: the retained speculative-tail window already covers the
    # slice, so the read is served zero-copy with no extra request
    assert store.stats.range_gets == gets_before

    big = _put(store, build_uniform_tgb("t2", 2, 1, "p", 0, 64 * 1024),
               key="t/big.tgb")
    r2 = TGBReader(store, big)
    r2.footer()
    gets_before = store.stats.range_gets
    r2.footer()
    r2.read_slice(0, 0)
    assert store.stats.range_gets == gets_before + 1  # only the slice read


def test_bad_magic(store):
    store.put("bad", b"not a tgb at all" * 4)
    with pytest.raises(TGBFormatError):
        TGBReader(store, "bad").footer()


@settings(max_examples=25, deadline=None)
@given(
    dp=st.integers(1, 4), cp=st.integers(1, 3),
    sizes=st.lists(st.integers(0, 512), min_size=12, max_size=12),
    data=st.data(),
)
def test_property_roundtrip_random_slices(dp, cp, sizes, data):
    store = MemoryObjectStore()
    b = TGBBuilder("t", dp=dp, cp=cp, producer_id="p", producer_seq=0)
    payloads = {}
    i = 0
    for d in range(dp):
        for c in range(cp):
            n = sizes[i % len(sizes)]
            i += 1
            payloads[(d, c)] = bytes([(d * 31 + c * 7 + j) % 256
                                      for j in range(n)])
            b.add_slice(d, c, payloads[(d, c)])
    store.put("k", b.build())
    r = TGBReader(store, "k")
    for (d, c), want in payloads.items():
        assert r.read_slice(d, c) == want
    # slices are contiguous and non-overlapping
    entries = sorted(r.footer().slices)
    for (o1, l1, _), (o2, _l2, _) in zip(entries, entries[1:]):
        assert o1 + l1 <= o2
