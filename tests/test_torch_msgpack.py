"""The port's msgpack codec (``repro_torch.core._msgpack``) against msgpack.

The data plane's wire documents must be byte-identical between the packages,
so a store written by one reads back in the other. Each document type is
taken from a store the JAX package wrote (TGB footers, flat and delta
manifests, the shard config, watermarks, the trim marker) or minted by it (a
Checkpoint token), re-encoded by the port and compared byte for byte; the
port's own encoders are held to the same bytes. Seeded random trees of the
codec's subset check ``packb`` at both ``use_bin_type`` settings and
``unpackb`` against ``msgpack.unpackb``.
"""
import base64
import struct

import numpy as np
import pytest

pytest.importorskip("torch")
msgpack = pytest.importorskip("msgpack")

from repro.core import MemoryObjectStore  # noqa: E402
from repro.core.manifest import MANIFEST_FORMAT_FLAT  # noqa: E402
from repro.core.tgb import TGBFooter as JaxFooter  # noqa: E402
from repro.dataplane import Topology, open_dataplane  # noqa: E402
from repro_torch.core import _msgpack  # noqa: E402
from repro_torch.core import manifest as tmanifest  # noqa: E402
from repro_torch.core.lifecycle import Watermark  # noqa: E402
from repro_torch.core.objectstore import MemoryObjectStore as TStore  # noqa: E402
from repro_torch.core.objectstore import Namespace  # noqa: E402
from repro_torch.core.tgb import TGBFooter  # noqa: E402
from repro_torch.dataplane.types import Checkpoint  # noqa: E402

TOPO = Topology(dp=2, cp=2, global_batch=4, seq_len=16)


def _footer_bytes(blob: bytes) -> bytes:
    """A TGB's footer: [footer msgpack][u64 footer_len][u64 magic]."""
    (n,) = struct.unpack("<Q", blob[-16:-8])
    return blob[-16 - n:-16]


@pytest.fixture(scope="module")
def jax_documents():
    """{kind: [raw bytes, ...]} from a store the JAX package wrote: a
    single-chain run (flat manifests, watermarks, a trim marker after one
    reclaim) and a sharded run (shard config, delta manifests)."""
    store = MemoryObjectStore()
    tokens = (np.arange(6 * 64) * 7 + 3).astype(np.int32) % 1000
    sess = open_dataplane(store, TOPO, namespace="runs/flat")
    with sess.writer("w0") as w:
        w.write_tokens(tokens)
    readers = [sess.reader(dp_rank=d, cp_rank=c)
               for d in range(2) for c in range(2)]
    tokens_ck = []
    for r in readers:
        r.next_batch(timeout_s=5)
        r.next_batch(timeout_s=5)
        tokens_ck.append(r.checkpoint().encode())
        sess.save_watermark(readers.index(r), r.checkpoint())
    sess.reclaim()
    sess.close()
    sharded = open_dataplane(store, TOPO, namespace="runs/sharded",
                             manifest_shards=2)
    with sharded.writer("w0") as w:
        w.write_tokens(tokens)
    sharded.close()

    docs = {"footer": [], "manifest": [], "shard_config": [],
            "watermark": [], "trim_marker": [], "checkpoint": []}
    for key in store.list("runs/"):
        raw = store.get(key)
        if key.endswith(".tgb"):
            docs["footer"].append(_footer_bytes(raw))
        elif key.endswith(".manifest"):
            docs["manifest"].append(raw)
        elif key.endswith("shards.cfg"):
            docs["shard_config"].append(raw)
        elif key.endswith(".wm"):
            docs["watermark"].append(raw)
        elif key.endswith("trim.marker"):
            docs["trim_marker"].append(raw)
    docs["checkpoint"] = [base64.urlsafe_b64decode(t) for t in tokens_ck]
    for kind, raws in docs.items():
        assert raws, f"the JAX run wrote no {kind} document"
    return docs


KINDS = ["footer", "manifest", "shard_config", "watermark", "trim_marker",
         "checkpoint"]


@pytest.mark.parametrize("kind", KINDS)
def test_codec_rewrites_each_data_plane_document_byte_for_byte(
        jax_documents, kind):
    for raw in jax_documents[kind]:
        doc = msgpack.unpackb(raw, raw=False, strict_map_key=False)
        assert _msgpack.unpackb(raw, raw=False, strict_map_key=False) == doc
        # the writers' own flags: use_bin_type=True (explicit or default)
        assert _msgpack.packb(doc, use_bin_type=True) == raw
        assert _msgpack.packb(doc) == raw


def test_port_encoders_write_the_reference_bytes(jax_documents):
    for raw in jax_documents["footer"]:
        assert TGBFooter.from_bytes(raw).to_bytes() == raw
        assert JaxFooter.from_bytes(raw).to_bytes() == raw
    for raw in jax_documents["watermark"]:
        assert Watermark.unpack(raw).pack() == raw
    for raw in jax_documents["checkpoint"]:
        token = base64.urlsafe_b64encode(raw).decode("ascii")
        assert Checkpoint.decode(token).encode() == token
    # flat manifests: decode with the port, re-encode the view
    flat = [r for r in jax_documents["manifest"]
            if msgpack.unpackb(r, raw=False, strict_map_key=False)["format"]
            == MANIFEST_FORMAT_FLAT]
    assert flat
    for raw in flat:
        store = TStore()
        ns = Namespace(store, "runs/x")
        doc = tmanifest.decode_manifest(raw)
        store.put(ns.manifest_key(doc["version"]), raw)
        view = tmanifest.ManifestStore(ns).load_view(doc["version"])
        assert tmanifest.encode_flat_manifest(view) == raw
    # the shard config as write_shard_config writes it
    ns = Namespace(TStore(), "runs/sharded")
    tmanifest.write_shard_config(ns, 2)
    assert ns.store.get(tmanifest.shards_cfg_key(ns)) \
        in jax_documents["shard_config"]


def _random_tree(rng, depth=0):
    kinds = ["nil", "bool", "int", "float", "str", "bin"]
    if depth < 3:
        kinds += ["list", "map"]
    k = kinds[rng.integers(len(kinds))]
    if k == "nil":
        return None
    if k == "bool":
        return bool(rng.integers(2))
    if k == "int":
        edges = [0, 0x7F, 0x80, 0xFF, 0x100, 0xFFFF, 0x10000, 0xFFFFFFFF,
                 0x100000000, 2**64 - 1, -1, -32, -33, -128, -129, -32768,
                 -32769, -2**31, -2**31 - 1, -2**63]
        if rng.integers(2):
            return int(edges[rng.integers(len(edges))])
        return int(rng.integers(-2**62, 2**62))
    if k == "float":
        return float(rng.standard_normal() * 10.0 ** rng.integers(-30, 30))
    if k == "str":
        n = int([3, 31, 32, 200, 255, 256, 70000][rng.integers(7)])
        return "".join(chr(c) for c in rng.integers(32, 0x4FF, n))
    if k == "bin":
        n = int([0, 5, 255, 256, 70000][rng.integers(5)])
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    n = int([0, 3, 15, 16, 40][rng.integers(5)])
    if k == "list":
        return [_random_tree(rng, depth + 1) for _ in range(n)]
    return {f"k{i}" if rng.integers(3) else int(i): _random_tree(rng, depth + 1)
            for i in range(n)}


@pytest.mark.parametrize("use_bin_type", [True, False])
@pytest.mark.parametrize("seed", range(4))
def test_random_trees_pack_like_msgpack(seed, use_bin_type):
    rng = np.random.default_rng(seed)
    for _ in range(25):
        tree = _random_tree(rng)
        assert _msgpack.packb(tree, use_bin_type=use_bin_type) == \
            msgpack.packb(tree, use_bin_type=use_bin_type)


@pytest.mark.parametrize("seed", range(4))
def test_unpackb_inverts_msgpack_packb(seed):
    rng = np.random.default_rng(100 + seed)
    for _ in range(25):
        raw = msgpack.packb(_random_tree(rng), use_bin_type=True)
        for raw_flag in (False, True):
            assert _msgpack.unpackb(raw, raw=raw_flag, strict_map_key=False) \
                == msgpack.unpackb(raw, raw=raw_flag, strict_map_key=False)


def test_tuples_pack_as_arrays_and_strict_map_keys_refuse_ints():
    assert _msgpack.packb((1, "a", b"b")) == msgpack.packb((1, "a", b"b"))
    raw = msgpack.packb({1: 2})
    with pytest.raises(ValueError):
        _msgpack.unpackb(raw, raw=False)
    assert _msgpack.unpackb(raw, raw=False, strict_map_key=False) == {1: 2}


@pytest.mark.parametrize("obj", [
    {1, 2}, np.int64(3), np.float32(1.5), object(), complex(1, 2),
    [np.array([1, 2])], {"a": msgpack.ExtType(1, b"x")}])
def test_codec_refuses_types_outside_the_subset(obj):
    with pytest.raises(TypeError):
        _msgpack.packb(obj)


@pytest.mark.parametrize("raw", [
    msgpack.packb(msgpack.ExtType(3, b"abcd")),      # ext
    b"\xca\x3f\xc0\x00\x00",                         # float32
    b"\x92\x01",                                     # truncated array
    b"\x01\x02",                                     # trailing bytes
])
def test_unpackb_refuses_bytes_outside_the_subset(raw):
    with pytest.raises(ValueError):
        _msgpack.unpackb(raw)
