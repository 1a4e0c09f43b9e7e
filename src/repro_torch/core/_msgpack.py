"""A msgpack codec for the data plane's documents (no third-party package).

The data plane's wire documents (TGB footers, manifests, shard configs,
watermarks, trim markers, Checkpoint tokens) are msgpack. ``packb`` writes
the same bytes as ``msgpack.packb`` (msgpack 1.x, default options) for the
subset those documents use, so a store written by either package reads back
in the other:

  nil, bool, int (fixint .. int64 / uint64), float64, str (fixstr,
  str8/16/32), bin8/16/32, array and map (fix/16/32).

``use_bin_type`` defaults to True as in msgpack 1.x; with False, bytes are
written as raw strings and str8 is never used (the pre-2013 spec), again as
msgpack does. ``unpackb`` reads the same subset. Any other type (ext,
float32 on the wire, numpy scalars that are not Python ints or floats)
raises ``TypeError`` on pack and ``ValueError`` on unpack; so do tuple
subclasses, which msgpack would write as arrays or ext types.
"""
from __future__ import annotations

import struct

__all__ = ["packb", "unpackb"]

_MAX_DEPTH = 512


def packb(obj, use_bin_type: bool = True) -> bytes:
    out = bytearray()
    _pack(obj, out, use_bin_type, _MAX_DEPTH)
    return bytes(out)


def _raw_header(n: int, out: bytearray, use_bin_type: bool) -> None:
    if n <= 0x1F:
        out.append(0xA0 | n)
    elif use_bin_type and n <= 0xFF:
        out += struct.pack(">BB", 0xD9, n)
    elif n <= 0xFFFF:
        out += struct.pack(">BH", 0xDA, n)
    elif n <= 0xFFFFFFFF:
        out += struct.pack(">BI", 0xDB, n)
    else:
        raise ValueError("str is too large")


def _bin_header(n: int, out: bytearray, use_bin_type: bool) -> None:
    if not use_bin_type:
        _raw_header(n, out, use_bin_type)
    elif n <= 0xFF:
        out += struct.pack(">BB", 0xC4, n)
    elif n <= 0xFFFF:
        out += struct.pack(">BH", 0xC5, n)
    elif n <= 0xFFFFFFFF:
        out += struct.pack(">BI", 0xC6, n)
    else:
        raise ValueError("bytes is too large")


def _container_header(n: int, out: bytearray, fix: int, b16: int,
                      b32: int) -> None:
    if n <= 0x0F:
        out.append(fix | n)
    elif n <= 0xFFFF:
        out += struct.pack(">BH", b16, n)
    elif n <= 0xFFFFFFFF:
        out += struct.pack(">BI", b32, n)
    else:
        raise ValueError("container is too large")


def _pack_int(v: int, out: bytearray) -> None:
    if 0 <= v < 0x80:
        out.append(v)
    elif -0x20 <= v < 0:
        out += struct.pack("b", v)
    elif 0x80 <= v <= 0xFF:
        out += struct.pack("BB", 0xCC, v)
    elif -0x80 <= v < 0:
        out += struct.pack(">Bb", 0xD0, v)
    elif 0xFF < v <= 0xFFFF:
        out += struct.pack(">BH", 0xCD, v)
    elif -0x8000 <= v < -0x80:
        out += struct.pack(">Bh", 0xD1, v)
    elif 0xFFFF < v <= 0xFFFFFFFF:
        out += struct.pack(">BI", 0xCE, v)
    elif -0x80000000 <= v < -0x8000:
        out += struct.pack(">Bi", 0xD2, v)
    elif 0xFFFFFFFF < v <= 0xFFFFFFFFFFFFFFFF:
        out += struct.pack(">BQ", 0xCF, v)
    elif -0x8000000000000000 <= v < -0x80000000:
        out += struct.pack(">Bq", 0xD3, v)
    else:
        raise OverflowError("Integer value out of range")


def _pack(obj, out: bytearray, use_bin_type: bool, depth: int) -> None:
    if depth < 0:
        raise ValueError("recursion limit exceeded")
    # the order of the checks is msgpack's: bool before int (a subclass)
    if obj is None:
        out.append(0xC0)
    elif isinstance(obj, bool):
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        _bin_header(len(data), out, use_bin_type)
        out += data
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _raw_header(len(data), out, use_bin_type)
        out += data
    elif isinstance(obj, float):
        out += struct.pack(">Bd", 0xCB, obj)
    elif isinstance(obj, list) or type(obj) is tuple:
        # tuple subclasses (named tuples, msgpack's ExtType) are refused
        _container_header(len(obj), out, 0x90, 0xDC, 0xDD)
        for v in obj:
            _pack(v, out, use_bin_type, depth - 1)
    elif isinstance(obj, dict):
        _container_header(len(obj), out, 0x80, 0xDE, 0xDF)
        for k, v in obj.items():
            _pack(k, out, use_bin_type, depth - 1)
            _pack(v, out, use_bin_type, depth - 1)
    else:
        raise TypeError(f"Cannot serialize {obj!r}")


# ---------------------------------------------------------------------------
# Unpacking
# ---------------------------------------------------------------------------

_FIXED = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
          0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q", 0xCB: ">d"}
_STR_LEN = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
_BIN_LEN = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
_ARR_LEN = {0xDC: ">H", 0xDD: ">I"}
_MAP_LEN = {0xDE: ">H", 0xDF: ">I"}


class _Reader:
    __slots__ = ("buf", "pos", "raw", "strict_map_key")

    def __init__(self, buf: bytes, raw: bool, strict_map_key: bool):
        self.buf = buf
        self.pos = 0
        self.raw = raw
        self.strict_map_key = strict_map_key

    def take(self, n: int) -> bytes:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError("Unpack failed: incomplete input")
        b = self.buf[self.pos:end]
        self.pos = end
        return b

    def fixed(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def string(self, n: int):
        data = self.take(n)
        return data if self.raw else data.decode("utf-8")

    def value(self, depth: int):
        if depth < 0:
            raise ValueError("recursion limit exceeded")
        t = self.take(1)[0]
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0xA0 <= t <= 0xBF:
            return self.string(t & 0x1F)
        if 0x90 <= t <= 0x9F:
            return self.array(t & 0x0F, depth)
        if 0x80 <= t <= 0x8F:
            return self.map(t & 0x0F, depth)
        if t == 0xC0:
            return None
        if t == 0xC2:
            return False
        if t == 0xC3:
            return True
        if t in _FIXED:
            return self.fixed(_FIXED[t])
        if t in _STR_LEN:
            return self.string(self.fixed(_STR_LEN[t]))
        if t in _BIN_LEN:
            return self.take(self.fixed(_BIN_LEN[t]))
        if t in _ARR_LEN:
            return self.array(self.fixed(_ARR_LEN[t]), depth)
        if t in _MAP_LEN:
            return self.map(self.fixed(_MAP_LEN[t]), depth)
        raise ValueError(f"msgpack type byte 0x{t:02x} is outside the data "
                         f"plane's subset")

    def array(self, n: int, depth: int) -> list:
        return [self.value(depth - 1) for _ in range(n)]

    def map(self, n: int, depth: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value(depth - 1)
            if self.strict_map_key and not isinstance(k, (str, bytes)):
                raise ValueError(f"{type(k).__name__} is not allowed for map "
                                 f"key when strict_map_key=True")
            out[k] = self.value(depth - 1)
        return out


def unpackb(raw_bytes, raw: bool = False, strict_map_key: bool = True):
    """Decode one msgpack document (arrays as lists, maps as dicts); trailing
    bytes, truncated input and types outside the subset raise ValueError."""
    r = _Reader(bytes(raw_bytes), raw, strict_map_key)
    obj = r.value(_MAX_DEPTH)
    if r.pos != len(r.buf):
        raise ValueError("Unpack failed: extra data after the document")
    return obj
