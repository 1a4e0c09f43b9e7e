"""Transactional Global Batch (TGB) physical layout (paper §4.1).

A TGB materializes one Global Batch ``B_s`` as an immutable object:

    [slice(0,0)][slice(0,1)] ... [slice(D-1,C-1)] [footer msgpack] [u64 footer_len] [u64 magic]

* ``D x C`` contiguous data slices, row-major ``(d * C + c)``; slice ``(d, c)``
  holds the token chunk for CP rank ``c`` of DP replica ``d``. TP/PP ranks are
  transparent: they derive identical ``(d, c)`` coordinates and read the same slice.
* The footer index records byte offset + length + crc32 per slice, so a consumer
  reads the footer once (two small range reads), caches it, and thereafter issues
  exactly one targeted range read per step — read amplification ~= 1x.

Objects are write-once: producers write independently, consumers cache without
coherence overhead.
"""
from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core import _msgpack as msgpack

from repro_torch.core.objectstore import ObjectStore

TGB_MAGIC = 0x7B47B347000054B2  # arbitrary 64-bit magic ("TGB")
_TAIL = struct.Struct("<QQ")  # footer_len, magic
TAIL_BYTES = _TAIL.size

#: Speculative footer over-read window: one ranged GET of the object's last
#: ~4 KiB almost always covers tail + footer (a D x C index entry is ~20 B
#: packed), collapsing the two-request footer open into one. Footers bigger
#: than the window fall back to an exact read of the missing prefix.
SPECULATIVE_TAIL_BYTES = 4096


class TGBFormatError(ValueError):
    pass


@dataclass(frozen=True)
class TGBFooter:
    """Lightweight per-TGB index: one entry per (d, c) slice.

    ``provenance`` is the canonical derivation record carried by *derived*
    TGBs (outputs of an op graph, see ``repro.graph``): a plain wire dict
    ``{src_stream, src tgb ids, op chain, params hash, graph hash, out
    index}``. ``None`` on raw (externally produced) TGBs; the wire format
    omits the key entirely, so pre-provenance footers decode unchanged.
    """

    tgb_id: str
    dp: int
    cp: int
    # row-major (d * cp + c) -> (offset, length, crc32)
    slices: Tuple[Tuple[int, int, int], ...]
    num_samples: int
    token_count: int
    producer_id: str
    producer_seq: int
    provenance: Optional[dict] = None

    def slice_entry(self, d: int, c: int) -> Tuple[int, int, int]:
        if not (0 <= d < self.dp and 0 <= c < self.cp):
            raise IndexError(f"slice ({d},{c}) out of range ({self.dp}x{self.cp})")
        return self.slices[d * self.cp + c]

    def to_bytes(self) -> bytes:
        doc = {
            "tgb_id": self.tgb_id,
            "dp": self.dp,
            "cp": self.cp,
            "slices": [list(s) for s in self.slices],
            "num_samples": self.num_samples,
            "token_count": self.token_count,
            "producer_id": self.producer_id,
            "producer_seq": self.producer_seq,
        }
        if self.provenance is not None:
            doc["provenance"] = self.provenance
        return msgpack.packb(doc, use_bin_type=True)

    @staticmethod
    def from_bytes(raw) -> "TGBFooter":
        """Decode from any bytes-like object (``bytes`` or a zero-copy
        ``memoryview`` over a larger fetch buffer)."""
        d = msgpack.unpackb(raw, raw=False)
        return TGBFooter(
            tgb_id=d["tgb_id"], dp=d["dp"], cp=d["cp"],
            slices=tuple(tuple(s) for s in d["slices"]),
            num_samples=d["num_samples"], token_count=d["token_count"],
            producer_id=d["producer_id"], producer_seq=d["producer_seq"],
            provenance=d.get("provenance"),
        )


class TGBBuilder:
    """Assemble a TGB from per-(d, c) slice payloads."""

    def __init__(self, tgb_id: str, dp: int, cp: int, producer_id: str,
                 producer_seq: int, num_samples: int = 0, token_count: int = 0,
                 provenance: Optional[dict] = None):
        self.tgb_id = tgb_id
        self.dp = dp
        self.cp = cp
        self.producer_id = producer_id
        self.producer_seq = producer_seq
        self.num_samples = num_samples
        self.token_count = token_count
        self.provenance = provenance
        self._slices: Dict[Tuple[int, int], bytes] = {}

    def add_slice(self, d: int, c: int, payload: bytes) -> "TGBBuilder":
        if not (0 <= d < self.dp and 0 <= c < self.cp):
            raise IndexError(f"slice ({d},{c}) out of range ({self.dp}x{self.cp})")
        if (d, c) in self._slices:
            raise ValueError(f"slice ({d},{c}) already added")
        self._slices[(d, c)] = payload
        return self

    def build(self) -> bytes:
        missing = [(d, c) for d in range(self.dp) for c in range(self.cp)
                   if (d, c) not in self._slices]
        if missing:
            raise TGBFormatError(f"incomplete TGB, missing slices {missing[:4]}...")
        # Single-pass assembly: collect payload references and b"".join once at
        # the end — no intermediate bytes concatenation, no bytearray growth.
        parts: List[bytes] = []
        entries: List[Tuple[int, int, int]] = []
        offset = 0
        for d in range(self.dp):
            for c in range(self.cp):
                payload = self._slices[(d, c)]
                entries.append((offset, len(payload), zlib.crc32(payload)))
                parts.append(payload)
                offset += len(payload)
        footer = TGBFooter(
            tgb_id=self.tgb_id, dp=self.dp, cp=self.cp, slices=tuple(entries),
            num_samples=self.num_samples, token_count=self.token_count,
            producer_id=self.producer_id, producer_seq=self.producer_seq,
            provenance=self.provenance,
        ).to_bytes()
        parts.append(footer)
        parts.append(_TAIL.pack(len(footer), TGB_MAGIC))
        return b"".join(parts)


def build_uniform_tgb(tgb_id: str, dp: int, cp: int, producer_id: str,
                      producer_seq: int, slice_bytes: int,
                      fill: Optional[bytes] = None,
                      num_samples: int = 0, token_count: int = 0) -> bytes:
    """Convenience: build a TGB whose every slice is ``slice_bytes`` long
    (synthetic benchmark payloads)."""
    b = TGBBuilder(tgb_id, dp, cp, producer_id, producer_seq,
                   num_samples=num_samples, token_count=token_count)
    for d in range(dp):
        for c in range(cp):
            if fill is not None:
                payload = (fill * (slice_bytes // max(1, len(fill)) + 1))[:slice_bytes]
            else:
                seed = (hash((tgb_id, d, c)) & 0xFF)
                payload = bytes([seed]) * slice_bytes
            b.add_slice(d, c, payload)
    return b.build()


def parse_footer(tail_and_footer_reader) -> TGBFooter:
    raise NotImplementedError  # see TGBReader


class TGBReader:
    """Read slices of a TGB object via targeted range reads.

    Footer open costs **one** small range read the first time: a speculative
    over-read of the object's tail window usually covers tail + footer, with
    an exact fallback read of the missing prefix for oversized footers.
    Callers should cache the returned footer per TGB (the consumer client
    does). ``footer_overhead_bytes`` records what the open actually fetched so
    read-amplification accounting stays honest about the over-read.
    """

    def __init__(self, store: ObjectStore, object_key: str,
                 object_size: Optional[int] = None,
                 speculative_tail: int = SPECULATIVE_TAIL_BYTES):
        self.store = store
        self.key = object_key
        self._size = object_size
        self._footer: Optional[TGBFooter] = None
        self.speculative_tail = speculative_tail
        self.footer_overhead_bytes = 0
        self.footer_len = 0
        # bytes the last read_slice/read_slices actually pulled from the
        # store (0 when served zero-copy out of the retained tail window)
        self.last_fetch_bytes = 0
        self._window: Optional[memoryview] = None
        self._window_off = 0

    @property
    def size(self) -> int:
        if self._size is None:
            self._size = self.store.head(self.key)
        return self._size

    def footer(self) -> TGBFooter:
        if self._footer is not None:
            return self._footer
        size = self.size
        if size < TAIL_BYTES:
            raise TGBFormatError(f"{self.key}: object smaller than tail")
        window = max(self.speculative_tail, TAIL_BYTES) if self.speculative_tail > 0 \
            else TAIL_BYTES
        window = min(window, size)
        buf = memoryview(self.store.get_range(self.key, size - window, window))
        if len(buf) != window:
            raise TGBFormatError(f"{self.key}: truncated tail")
        fetched = window
        footer_len, magic = _TAIL.unpack(buf[-TAIL_BYTES:])
        if magic != TGB_MAGIC:
            raise TGBFormatError(f"{self.key}: bad magic {magic:#x}")
        if footer_len > size - TAIL_BYTES:
            raise TGBFormatError(f"{self.key}: footer length {footer_len} "
                                 f"exceeds object size {size}")
        # retain the window: slice reads that fall inside it are served
        # zero-copy instead of re-fetched (small TGBs often fit entirely)
        self._window = buf
        self._window_off = size - window
        avail = window - TAIL_BYTES
        if footer_len <= avail:
            # speculative hit: footer decodes zero-copy out of the tail window
            footer_view = buf[avail - footer_len:avail]
        else:
            # miss (footer bigger than the window): fetch only the missing
            # prefix and splice it onto what the window already covers
            missing = footer_len - avail
            prefix = self.store.get_range(
                self.key, size - TAIL_BYTES - footer_len, missing)
            if len(prefix) != missing:
                raise TGBFormatError(f"{self.key}: short footer read")
            fetched += missing
            footer_view = memoryview(b"".join([prefix, buf[:avail]]))
        self._footer = TGBFooter.from_bytes(footer_view)
        self.footer_overhead_bytes = fetched
        self.footer_len = footer_len
        return self._footer

    def _from_window(self, off: int, length: int) -> Optional[memoryview]:
        """Zero-copy view over the retained tail window, if it covers
        ``[off, off + length)``."""
        if self._window is None:
            return None
        if off >= self._window_off and \
                off + length <= self._window_off + len(self._window):
            s = off - self._window_off
            return self._window[s:s + length]
        return None

    def set_cached_footer(self, footer: TGBFooter, size: int) -> None:
        self._footer = footer
        self._size = size

    def read_slice(self, d: int, c: int, verify: bool = True) -> bytes:
        off, length, crc = self.footer().slice_entry(d, c)
        view = self._from_window(off, length)
        if view is not None:
            data = bytes(view)
            self.last_fetch_bytes = 0
        else:
            data = self.store.get_range(self.key, off, length)
            self.last_fetch_bytes = len(data)
        if len(data) != length:
            raise TGBFormatError(f"{self.key}: short read for slice ({d},{c})")
        if verify and zlib.crc32(data) != crc:
            raise TGBFormatError(f"{self.key}: crc mismatch for slice ({d},{c})")
        return data

    def read_slices(self, d: int, c_start: int, span: int,
                    verify: bool = True) -> bytes:
        """Read slices ``(d, c_start) .. (d, c_start + span - 1)`` with one
        vectored ranged GET (CP-shrink span: one coalesced request instead of
        ``span`` sequential round trips — row-major adjacency makes the span
        a single contiguous range). CRCs are verified per slice over zero-copy
        views; the returned payload is the concatenated span."""
        if span < 1:
            raise ValueError(f"span must be >= 1, got {span}")
        f = self.footer()
        entries = [f.slice_entry(d, c_start + i) for i in range(span)]
        views = [self._from_window(off, ln) for off, ln, _ in entries]
        if all(v is not None for v in views):
            self.last_fetch_bytes = 0  # whole span inside the tail window
        else:
            views = self.store.get_ranges(
                self.key, [(off, ln) for off, ln, _ in entries])
            self.last_fetch_bytes = sum(ln for _, ln, _ in entries)
        for (off, ln, crc), view in zip(entries, views):
            if len(view) != ln:
                raise TGBFormatError(
                    f"{self.key}: short read in span at offset {off}")
            if verify and zlib.crc32(view) != crc:
                raise TGBFormatError(
                    f"{self.key}: crc mismatch in span at offset {off}")
        if len(views) == 1:
            return bytes(views[0])
        return b"".join(views)

    def read_full(self) -> bytes:
        """Dense read (baseline): fetch the whole object."""
        return self.store.get(self.key)


@dataclass(frozen=True)
class TGBDescriptor:
    """Manifest entry for one TGB (paper §4.2 'TGB list'). The descriptor's
    position in the authoritative list defines its global step index.

    ``provenance`` surfaces a derived TGB's canonical derivation record in
    the manifest itself (same wire dict as the footer's), so audits and
    lineage queries never have to open the object. The packed row carries it
    as an optional trailing element: pre-provenance manifests (9-element
    rows) unpack unchanged.
    """

    tgb_id: str
    object_key: str
    size_bytes: int
    dp: int
    cp: int
    num_samples: int
    token_count: int
    producer_id: str
    producer_seq: int  # stream offset within the producer (exactly-once key)
    provenance: Optional[dict] = None

    def pack(self) -> list:
        row = [self.tgb_id, self.object_key, self.size_bytes, self.dp, self.cp,
               self.num_samples, self.token_count, self.producer_id,
               self.producer_seq]
        if self.provenance is not None:
            row.append(self.provenance)
        return row

    @staticmethod
    def unpack(row: Sequence) -> "TGBDescriptor":
        return TGBDescriptor(*row)
