"""S3-like object store abstraction.

BatchWeave's entire control plane rests on four storage primitives:

  * atomic, immutable object PUT
  * **conditional PUT (If-None-Match: *)** — succeeds only if the key is unclaimed
  * ranged GET
  * LIST by prefix / DELETE (idempotent)

This container has no real object-store endpoint, so we provide two backends
(memory, filesystem) that implement identical semantics, plus an injectable
``LatencyModel`` calibrated to cloud object-store behaviour (per-op base latency
+ bytes/bandwidth) so the paper's commit-cadence dynamics (DAC's fragile window
grows with manifest size) are physically meaningful, and a ``FaultInjector`` for
crash/flakiness tests.

Conditional put is implemented with a locked check-insert (memory) and a
fully-written temp file claimed via atomic ``os.link`` (filesystem) —
semantically identical to S3/GCS/Azure ``If-None-Match:*`` used by the paper
(§6), including its all-or-nothing visibility: a winner is only ever observed
complete.
"""
from __future__ import annotations

import os
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.core.clock import Clock, SystemClock

#: Coalesce ranges whose inter-range gap is at most this many bytes into one
#: request. 512 KiB ~ the point where re-reading the gap is cheaper than a
#: second object-store round trip (gap/bandwidth < per-request base latency).
DEFAULT_COALESCE_GAP = 512 * 1024


class ConditionalPutFailed(Exception):
    """The key already exists: another writer won the race."""


class NoSuchKey(KeyError):
    pass


@dataclass
class LatencyModel:
    """First-order cloud object store cost model: latency = base + bytes/bandwidth.

    Defaults approximate a same-region S3-class store (sub-ms within-DC RTT would
    be ~0.2 ms; object stores sit at ~10-30 ms TTFB with ~100 MB/s-class
    single-stream bandwidth). All benchmarks report *relative* numbers, matching
    the paper's claims.
    """

    put_base_s: float = 0.015
    get_base_s: float = 0.010
    list_base_s: float = 0.012
    delete_base_s: float = 0.008
    head_base_s: float = 0.006
    put_bw_Bps: float = 300e6
    get_bw_Bps: float = 500e6
    jitter_frac: float = 0.10  # +/- uniform jitter fraction

    _rng: "object" = field(default=None, repr=False)

    def _jitter(self, t: float) -> float:
        if self.jitter_frac <= 0:
            return t
        if self._rng is None:
            import random

            object.__setattr__(self, "_rng", random.Random(0xB47C4))
        u = self._rng.uniform(-self.jitter_frac, self.jitter_frac)
        return t * (1.0 + u)

    def put_delay(self, nbytes: int) -> float:
        return self._jitter(self.put_base_s + nbytes / self.put_bw_Bps)

    def get_delay(self, nbytes: int) -> float:
        return self._jitter(self.get_base_s + nbytes / self.get_bw_Bps)

    def list_delay(self, nkeys: int) -> float:
        return self._jitter(self.list_base_s + 1e-6 * nkeys)

    def delete_delay(self) -> float:
        return self._jitter(self.delete_base_s)

    def head_delay(self) -> float:
        return self._jitter(self.head_base_s)


ZERO_LATENCY = LatencyModel(
    put_base_s=0.0, get_base_s=0.0, list_base_s=0.0, delete_base_s=0.0,
    head_base_s=0.0, put_bw_Bps=float("inf"), get_bw_Bps=float("inf"),
    jitter_frac=0.0,
)


@dataclass
class StoreStats:
    puts: int = 0
    conditional_puts: int = 0
    conditional_put_conflicts: int = 0
    gets: int = 0
    range_gets: int = 0
    vectored_gets: int = 0      # get_ranges() calls
    coalesced_requests: int = 0  # physical requests issued by get_ranges()
    coalesced_ranges: int = 0    # logical ranges served by get_ranges()
    lists: int = 0
    deletes: int = 0
    heads: int = 0
    bytes_written: int = 0
    bytes_read: int = 0

    def snapshot(self) -> dict:
        return dict(self.__dict__)


def coalesce_ranges(ranges: Sequence[Tuple[int, int]],
                    gap_threshold: int = DEFAULT_COALESCE_GAP,
                    ) -> List[Tuple[int, int, List[Tuple[int, int, int]]]]:
    """Group ``(offset, length)`` ranges whose gaps are <= ``gap_threshold``.

    Returns ``[(group_offset, group_length, members)]`` where each member is
    ``(original_index, offset, length)``. Groups preserve ascending offset
    order; members keep their original indices so callers can restore request
    order. Overlapping/duplicate ranges coalesce naturally (gap < 0).
    """
    if not ranges:
        return []
    order = sorted(range(len(ranges)), key=lambda i: ranges[i][0])
    groups: List[Tuple[int, int, List[Tuple[int, int, int]]]] = []
    g_off, g_end = None, None
    members: List[Tuple[int, int, int]] = []
    for i in order:
        off, length = ranges[i]
        if length < 0 or off < 0:
            raise ValueError(f"bad range ({off}, {length})")
        if g_off is None:
            g_off, g_end, members = off, off + length, [(i, off, length)]
            continue
        if off - g_end <= gap_threshold:
            members.append((i, off, length))
            g_end = max(g_end, off + length)
        else:
            groups.append((g_off, g_end - g_off, members))
            g_off, g_end, members = off, off + length, [(i, off, length)]
    groups.append((g_off, g_end - g_off, members))
    return groups


class FaultInjector:
    """Deterministic fault hooks: crash (raise) before/after the Nth matching op."""

    def __init__(self):
        self._rules: List[Tuple[str, str, int, str]] = []  # (op, key_substr, nth, phase)
        self._counts: Dict[Tuple[str, str, str], int] = {}
        self._lock = threading.Lock()

    def crash_on(self, op: str, key_substr: str = "", nth: int = 1, phase: str = "before"):
        self._rules.append((op, key_substr, nth, phase))

    def check(self, op: str, key: str, phase: str):
        with self._lock:
            for rule in self._rules:
                r_op, r_sub, r_nth, r_phase = rule
                if r_op == op and r_phase == phase and r_sub in key:
                    ck = (r_op, r_sub, r_phase)
                    self._counts[ck] = self._counts.get(ck, 0) + 1
                    if self._counts[ck] == r_nth:
                        raise InjectedCrash(f"injected crash: {op} {key} ({phase})")


class InjectedCrash(RuntimeError):
    pass


class ObjectStore:
    """Abstract object store. All mutating ops are atomic at object granularity."""

    def __init__(self, latency: Optional[LatencyModel] = None,
                 clock: Optional[Clock] = None,
                 faults: Optional[FaultInjector] = None):
        self.latency = latency or ZERO_LATENCY
        self.clock = clock or SystemClock()
        self.faults = faults
        self.stats = StoreStats()
        self._stats_lock = threading.Lock()

    # -- hooks ------------------------------------------------------------
    def _pre(self, op: str, key: str):
        if self.faults is not None:
            self.faults.check(op, key, "before")

    def _post(self, op: str, key: str):
        if self.faults is not None:
            self.faults.check(op, key, "after")

    # -- API ----------------------------------------------------------------
    def put(self, key: str, data: bytes) -> None:
        self._pre("put", key)
        self.clock.sleep(self.latency.put_delay(len(data)))
        self._do_put(key, data)
        with self._stats_lock:
            self.stats.puts += 1
            self.stats.bytes_written += len(data)
        self._post("put", key)

    def put_if_absent(self, key: str, data: bytes) -> bool:
        """Conditional put (If-None-Match:*). Returns True iff this call created
        the object. The latency is charged whether or not the put wins — the
        request travels to the store either way (this is the fragile window)."""
        self._pre("cput", key)
        self.clock.sleep(self.latency.put_delay(len(data)))
        ok = self._do_put_if_absent(key, data)
        with self._stats_lock:
            self.stats.conditional_puts += 1
            if ok:
                self.stats.bytes_written += len(data)
            else:
                self.stats.conditional_put_conflicts += 1
        self._post("cput", key)
        return ok

    def get(self, key: str) -> bytes:
        self._pre("get", key)
        data = self._do_get(key)
        self.clock.sleep(self.latency.get_delay(len(data)))
        with self._stats_lock:
            self.stats.gets += 1
            self.stats.bytes_read += len(data)
        self._post("get", key)
        return data

    def get_range(self, key: str, start: int, length: int) -> bytes:
        self._pre("get_range", key)
        data = self._do_get_range(key, start, length)
        self.clock.sleep(self.latency.get_delay(len(data)))
        with self._stats_lock:
            self.stats.range_gets += 1
            self.stats.bytes_read += len(data)
        self._post("get_range", key)
        return data

    def get_ranges(self, key: str, ranges: Sequence[Tuple[int, int]],
                   gap_threshold: int = DEFAULT_COALESCE_GAP) -> List[memoryview]:
        """Vectored ranged GET: fetch many ``(offset, length)`` ranges of one
        object, coalescing adjacent/near ranges (gap <= ``gap_threshold``) into
        a single request each.

        Latency is charged **once per coalesced request** — this is the whole
        point: ``span`` adjacent slice reads cost one round trip instead of
        ``span``. Returns zero-copy ``memoryview`` slices over each request's
        buffer, in the order of the input ``ranges``. Gap bytes that were
        fetched only to bridge ranges are counted in ``bytes_read`` (they went
        over the wire).
        """
        self._pre("get_ranges", key)
        out: List[Optional[memoryview]] = [None] * len(ranges)
        groups = coalesce_ranges(ranges, gap_threshold)
        fetched = 0
        for g_off, g_len, members in groups:
            data = self._do_get_range(key, g_off, g_len)
            self.clock.sleep(self.latency.get_delay(len(data)))
            fetched += len(data)
            view = memoryview(data)
            for idx, off, length in members:
                out[idx] = view[off - g_off:off - g_off + length]
        with self._stats_lock:
            self.stats.vectored_gets += 1
            self.stats.coalesced_requests += len(groups)
            self.stats.coalesced_ranges += len(ranges)
            self.stats.range_gets += len(groups)
            self.stats.bytes_read += fetched
        self._post("get_ranges", key)
        return out  # type: ignore[return-value]

    def head(self, key: str) -> int:
        """Return object size; raises NoSuchKey."""
        self._pre("head", key)
        self.clock.sleep(self.latency.head_delay())
        n = self._do_head(key)
        with self._stats_lock:
            self.stats.heads += 1
        self._post("head", key)
        return n

    def exists(self, key: str) -> bool:
        try:
            self.head(key)
            return True
        except NoSuchKey:
            return False

    def list(self, prefix: str) -> List[str]:
        self._pre("list", prefix)
        keys = self._do_list(prefix)
        self.clock.sleep(self.latency.list_delay(len(keys)))
        with self._stats_lock:
            self.stats.lists += 1
        self._post("list", prefix)
        return keys

    def delete(self, key: str) -> None:
        """Idempotent delete."""
        self._pre("delete", key)
        self.clock.sleep(self.latency.delete_delay())
        self._do_delete(key)
        with self._stats_lock:
            self.stats.deletes += 1
        self._post("delete", key)

    def total_bytes(self) -> int:
        """Total bytes currently stored (for lifecycle experiments)."""
        raise NotImplementedError

    # -- backend primitives ---------------------------------------------------
    def _do_put(self, key: str, data: bytes) -> None:
        raise NotImplementedError

    def _do_put_if_absent(self, key: str, data: bytes) -> bool:
        raise NotImplementedError

    def _do_get(self, key: str) -> bytes:
        raise NotImplementedError

    def _do_get_range(self, key: str, start: int, length: int) -> bytes:
        raise NotImplementedError

    def _do_head(self, key: str) -> int:
        raise NotImplementedError

    def _do_list(self, prefix: str) -> List[str]:
        raise NotImplementedError

    def _do_delete(self, key: str) -> None:
        raise NotImplementedError


class MemoryObjectStore(ObjectStore):
    """In-memory backend. Thread-safe; conditional put is a locked check-insert."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self._objects: Dict[str, bytes] = {}
        self._lock = threading.RLock()

    def _do_put(self, key, data):
        with self._lock:
            self._objects[key] = bytes(data)

    def _do_put_if_absent(self, key, data):
        with self._lock:
            if key in self._objects:
                return False
            self._objects[key] = bytes(data)
            return True

    def _do_get(self, key):
        with self._lock:
            if key not in self._objects:
                raise NoSuchKey(key)
            return self._objects[key]

    def _do_get_range(self, key, start, length):
        with self._lock:
            if key not in self._objects:
                raise NoSuchKey(key)
            return self._objects[key][start:start + length]

    def _do_head(self, key):
        with self._lock:
            if key not in self._objects:
                raise NoSuchKey(key)
            return len(self._objects[key])

    def _do_list(self, prefix):
        with self._lock:
            return sorted(k for k in self._objects if k.startswith(prefix))

    def _do_delete(self, key):
        with self._lock:
            self._objects.pop(key, None)

    def total_bytes(self):
        with self._lock:
            return sum(len(v) for v in self._objects.values())


class FileObjectStore(ObjectStore):
    """Filesystem backend. PUT = write-temp + rename (atomic); conditional
    PUT = write-temp + ``os.link`` (atomic claim on POSIX, fails with EEXIST
    if another writer won — the payload is complete before the key exists)."""

    def __init__(self, root: str, **kw):
        super().__init__(**kw)
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._tmp_counter = 0
        self._tmp_lock = threading.Lock()

    def _path(self, key: str) -> str:
        # keys are '/'-separated; map to directories. Disallow traversal.
        if ".." in key.split("/"):
            raise ValueError(f"bad key {key!r}")
        return os.path.join(self.root, *key.split("/"))

    def _write_tmp(self, path: str, data: bytes) -> str:
        """Write the full payload to a unique sibling temp file and return its
        path. The ``.tmp.`` infix is load-bearing: LIST and total_bytes
        exclude in-flight files by it."""
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with self._tmp_lock:
            self._tmp_counter += 1
            n = self._tmp_counter
        tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}.{n}"
        with open(tmp, "wb") as f:
            f.write(data)
        return tmp

    def _do_put(self, key, data):
        path = self._path(key)
        os.replace(self._write_tmp(path, data), path)

    def _do_put_if_absent(self, key, data):
        # A bare O_CREAT|O_EXCL open would make an *empty* object visible
        # before the payload lands, letting a concurrent reader observe a
        # truncated manifest/TGB. Write the full payload to a temp file first,
        # then claim the key with os.link — link(2) is atomic and fails with
        # EEXIST if another writer won, so the object is only ever visible
        # complete.
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        if os.path.exists(path):  # fast-path losers: skip the temp write
            return False
        tmp = self._write_tmp(path, data)
        try:
            os.link(tmp, path)
        except FileExistsError:
            return False
        finally:
            os.unlink(tmp)
        return True

    def _do_get(self, key):
        try:
            with open(self._path(key), "rb") as f:
                return f.read()
        except FileNotFoundError:
            raise NoSuchKey(key)

    def _do_get_range(self, key, start, length):
        try:
            with open(self._path(key), "rb") as f:
                f.seek(start)
                return f.read(length)
        except FileNotFoundError:
            raise NoSuchKey(key)

    def _do_head(self, key):
        try:
            return os.path.getsize(self._path(key))
        except FileNotFoundError:
            raise NoSuchKey(key)

    def _do_list(self, prefix):
        out = []
        base = self.root
        for dirpath, _dirnames, filenames in os.walk(base):
            for fn in filenames:
                if fn.startswith(".") or ".tmp." in fn:
                    continue
                full = os.path.join(dirpath, fn)
                key = os.path.relpath(full, base).replace(os.sep, "/")
                if key.startswith(prefix):
                    out.append(key)
        return sorted(out)

    def _do_delete(self, key):
        try:
            os.remove(self._path(key))
        except FileNotFoundError:
            pass

    def total_bytes(self):
        total = 0
        for dirpath, _d, filenames in os.walk(self.root):
            for fn in filenames:
                if ".tmp." in fn:
                    continue
                try:
                    total += os.path.getsize(os.path.join(dirpath, fn))
                except OSError:
                    pass
        return total


class IOPool:
    """Bounded executor for parallel object-store GETs.

    One pool is meant to be **shared** across all consumer clients of a
    process (every rank's prefetcher, every stream of a MixedReader) so the
    total number of in-flight object-store requests stays bounded no matter
    how many readers exist. Against the latency model this matters because
    each GET sleeps for its modeled round trip: overlapping those sleeps on
    pool threads is exactly how a real S3 client hides per-request latency.
    """

    _default: Optional["IOPool"] = None
    _default_lock = threading.Lock()

    def __init__(self, max_workers: int = 8, name: str = "bw-io"):
        if max_workers < 1:
            raise ValueError("IOPool needs at least one worker")
        self.max_workers = max_workers
        self._exec = ThreadPoolExecutor(max_workers=max_workers,
                                        thread_name_prefix=name)
        self.submitted = 0
        self._lock = threading.Lock()

    @classmethod
    def default(cls) -> "IOPool":
        """Process-wide shared pool (lazily created, never shut down)."""
        with cls._default_lock:
            if cls._default is None:
                cls._default = IOPool()
            return cls._default

    def submit(self, fn: Callable, *args, **kw) -> Future:
        with self._lock:
            self.submitted += 1
        return self._exec.submit(fn, *args, **kw)

    def shutdown(self, wait: bool = True) -> None:
        self._exec.shutdown(wait=wait)

    def __enter__(self) -> "IOPool":
        return self

    def __exit__(self, *exc) -> bool:
        self.shutdown()
        return False


class Namespace:
    """A training run's namespace prefix on an object store (§3: 'a new training
    job requires only a fresh namespace prefix')."""

    def __init__(self, store: ObjectStore, prefix: str):
        self.store = store
        self.prefix = prefix.rstrip("/")

    def key(self, *parts: str) -> str:
        return "/".join((self.prefix,) + parts)

    def stream(self, name: str) -> "Namespace":
        """Child namespace for one named TGB stream: ``<run>/streams/<name>``.

        Each stream is a fully independent manifest chain — its own producers,
        commit protocol, watermarks, and trim marker — so the single-stream
        clients run unmodified under a per-stream prefix.
        """
        if not name or "/" in name or name in (".", ".."):
            raise ValueError(f"bad stream name {name!r}")
        return Namespace(self.store, self.key("streams", name))

    def manifest_key(self, version: int) -> str:
        return self.key("manifest", f"{version:08d}.manifest")

    def tgb_key(self, producer_id: str, offset: int, token: str) -> str:
        return self.key("tgb", producer_id, f"{offset:012d}-{token}.tgb")

    def watermark_key(self, rank: int) -> str:
        return self.key("watermarks", f"rank{rank:05d}.wm")

    def trim_key(self) -> str:
        return self.key("control", "trim.marker")

    def checkpoint_key(self, step: int, name: str) -> str:
        return self.key("checkpoints", f"{step:010d}", name)
