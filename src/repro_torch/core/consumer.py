"""Consumer client (paper §3.1 stage 3, §4.4).

Embedded in each training rank. Maintains a cursor ``<V, S>`` (manifest version
being read, global step index), derives its ``(d, c)`` coordinates locally from
its mesh position, reads the footer index once per TGB (cached), and issues one
targeted range read per step. No inter-rank communication.

Also implements:
  * pipelined parallel prefetch of upcoming slices: up to ``prefetch_depth``
    slice fetches in flight concurrently on a shared ``IOPool`` (hides
    object-store read latency far better than the old one-at-a-time thread),
  * coalesced CP-span reads (one vectored ranged GET per step instead of
    ``span`` sequential round trips),
  * topology remap (§4.1): TP/PP changes are transparent; DP/CP world-size
    changes by an integer factor remap (logical step, rank) -> (tgb step, slice)
    locally with no data rewrite,
  * dense-read baseline mode (fetch full TGB, slice locally) for Fig. 10,
  * read-amplification accounting (speculative footer over-reads included).
"""
from __future__ import annotations

import threading
from concurrent.futures import Future, wait
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from repro_torch.core.errors import (BatchTimeout, FAIL_FAST_ERRORS,
                                     TransientStoreError, retry_transient)
from repro_torch.core.manifest import (DatasetView, ManifestStore,
                                       StepUnavailable, open_manifest_store)
from repro_torch.core.objectstore import IOPool, Namespace, NoSuchKey
from repro_torch.core.tgb import (SPECULATIVE_TAIL_BYTES, TAIL_BYTES,
                                  TGBFooter, TGBFormatError, TGBReader)
from repro_torch.obs.registry import COUNTER, GAUGE, HISTOGRAM, StatsView
from repro_torch.obs.tracer import trace_span


class ConsumerStats(StatsView):
    """Registry-backed read-path counters (``consumer.<instance>.*``).

    Field semantics are unchanged from the old dataclass; the values now
    live in the process metrics registry so the flight recorder and the
    ``batchweave obs`` CLI can see them. ``read_latencies`` is a registry
    ``Histogram`` — a ``LatencyWindow`` subclass, so iteration/``len``/
    ``append`` behave exactly as before. ``get_latencies`` holds every
    object-store GET of the read path (footer, slice and vectored reads,
    direct and prefetch), timed at the consumer's call into the store, so a
    resilient store's retries, hedges and governor waits are inside it.
    """

    _FAMILY = "consumer"
    _SPEC = {
        "steps_consumed": COUNTER,
        "bytes_consumed": COUNTER,   # payload actually used by this rank
        "bytes_fetched": COUNTER,    # payload + footer/header overhead fetched
        "footer_reads": COUNTER,
        "manifest_polls": COUNTER,
        "read_retries": COUNTER,     # transient-fault retries on the data path
        "read_latencies": HISTOGRAM,
        "get_latencies": HISTOGRAM,
        "prefetch_hits": COUNTER,
        "prefetch_misses": COUNTER,
        # degraded mode: batches served from prefetch while the store's
        # circuit breaker judged the backend down
        "degraded_batches": COUNTER,
        "store_degraded": GAUGE,
    }

    @property
    def read_amplification(self) -> float:
        return self.bytes_fetched / max(1, self.bytes_consumed)


class _TimedGets:
    """The store as the consumer's ``TGBReader``s see it: each GET (whole,
    ranged or vectored) is timed into ``consumer.get`` spans and the
    consumer's ``get_latencies``; everything else passes through."""

    def __init__(self, consumer: "Consumer"):
        self._consumer = consumer
        self._store = consumer.store

    def _timed(self, call, *args, **kw):
        c = self._consumer
        t0 = c.clock.now()
        try:
            with trace_span("consumer.get", cat="read") as span:
                out = call(*args, **kw)
                span.annotate(bytes=sum(len(v) for v in out)
                              if isinstance(out, list) else len(out))
        finally:
            # a GET that failed took its time too
            with c._stats_lock:
                c.stats.get_latencies.append(c.clock.now() - t0)
        return out

    def get(self, key: str) -> bytes:
        return self._timed(self._store.get, key)

    def get_range(self, key: str, start: int, length: int) -> bytes:
        return self._timed(self._store.get_range, key, start, length)

    def get_ranges(self, key: str, ranges, **kw) -> list:
        return self._timed(self._store.get_ranges, key, ranges, **kw)

    def __getattr__(self, name):
        return getattr(self._store, name)


@dataclass(frozen=True)
class MeshPosition:
    """This rank's data-relevant coordinates. TP/PP ranks of the same (d, c)
    group pass identical coordinates (data delivery is TP/PP-transparent)."""

    dp_rank: int
    cp_rank: int
    dp_size: int
    cp_size: int


def remap_step(logical_step: int, pos: MeshPosition,
               tgb_dp: int, tgb_cp: int) -> Tuple[int, int, int]:
    """Map (logical step, new-topology rank) -> (tgb step index, d, c) when the
    consuming topology differs from the TGB's materialized D x C layout by
    integer factors (paper §4.1 'Topology reconfiguration').

    * DP doubled (pos.dp_size = k * tgb_dp): k consecutive TGBs form one logical
      step; replica d reads TGB ``logical_step * k + d // tgb_dp``, slice
      ``d % tgb_dp``.
    * DP halved (tgb_dp = k * pos.dp_size): one TGB serves k logical steps; step
      ``s`` uses slice block ``(s % k) * pos.dp_size + d`` of TGB ``s // k``.
    * CP follows the same logic along the token-chunk dimension.
    """
    d, c = pos.dp_rank, pos.cp_rank
    step = logical_step
    # --- DP dimension ---
    if pos.dp_size == tgb_dp:
        td = d
    elif pos.dp_size > tgb_dp:
        if pos.dp_size % tgb_dp:
            raise ValueError(f"DP {pos.dp_size} not an integer multiple of TGB dp {tgb_dp}")
        k = pos.dp_size // tgb_dp
        step = step * k + d // tgb_dp
        td = d % tgb_dp
    else:
        if tgb_dp % pos.dp_size:
            raise ValueError(f"TGB dp {tgb_dp} not an integer multiple of DP {pos.dp_size}")
        k = tgb_dp // pos.dp_size
        td = (step % k) * pos.dp_size + d
        step = step // k
    # --- CP dimension (within the chosen TGB) ---
    if pos.cp_size == tgb_cp:
        tc = c
    elif pos.cp_size > tgb_cp:
        raise ValueError("CP growth requires sub-slice reads; materialize TGBs "
                         "with the max CP degree instead")
    else:
        if tgb_cp % pos.cp_size:
            raise ValueError(f"TGB cp {tgb_cp} not an integer multiple of CP {pos.cp_size}")
        # CP shrink: each consumer rank owns tgb_cp/cp_size consecutive chunks;
        # callers read them all (concatenated) for its longer token span.
        tc = c * (tgb_cp // pos.cp_size)
    return step, td, tc


def convert_logical_step(step: int, from_dp: int, to_dp: int) -> int:
    """Convert a logical step count between DP topologies that differ by an
    integer factor (§4.1 elastic restore).

    A logical step at DP degree ``d`` consumes ``d`` batch slices of the
    materialized stream, so ``step`` logical steps at ``from_dp`` occupy
    ``step * from_dp`` slices; the same position expressed at ``to_dp`` is
    ``step * from_dp / to_dp``. Raises ``ValueError`` when the degrees are
    not an integer factor apart, or when the position does not land on a
    ``to_dp`` global-batch boundary (the cursor would split a batch).
    """
    if from_dp < 1 or to_dp < 1:
        raise ValueError(f"DP degrees must be >= 1, got {from_dp} -> {to_dp}")
    if max(from_dp, to_dp) % min(from_dp, to_dp):
        raise ValueError(
            f"DP resize {from_dp} -> {to_dp} is not an integer factor")
    slices = step * from_dp
    if slices % to_dp:
        raise ValueError(
            f"step {step} at dp={from_dp} ({slices} slices) does not land on "
            f"a dp={to_dp} global-batch boundary")
    return slices // to_dp


def floor_to_data_step(step: int, dp: int, data_dp: int) -> int:
    """A logical cursor position in *materialized* (TGB-layout) units,
    floored — the resize-invariant unit retention/trim decisions use. A
    mid-boundary cursor can only round down, i.e. under-trim."""
    return (step * dp) // max(1, data_dp)


class Consumer:
    """One training rank's BatchWeave consumer client."""

    def __init__(self, ns: Namespace, pos: MeshPosition,
                 manifests: Optional[ManifestStore] = None,
                 prefetch_depth: int = 4,
                 dense_read: bool = False,
                 verify_crc: bool = True,
                 io_pool: Optional[IOPool] = None,
                 parallel_prefetch: bool = True,
                 coalesce_reads: bool = True,
                 speculative_tail: int = SPECULATIVE_TAIL_BYTES,
                 min_poll_interval_s: float = 0.02,
                 read_retries: int = 3,
                 stats_instance: Optional[str] = None,
                 obs_snap_interval_s: Optional[float] = None):
        self.ns = ns
        self.store = ns.store
        self.clock = self.store.clock
        self.pos = pos
        # default discovers the run's shard layout (``manifest/shards.cfg``):
        # readers of sharded runs transparently get the merged view
        self.manifests = manifests if manifests is not None \
            else open_manifest_store(ns)
        self.view: DatasetView = DatasetView()
        self.step = 0  # next global step S to consume
        self.dense_read = dense_read
        self.verify_crc = verify_crc
        # I/O path knobs: the defaults are the fast path; benchmarks flip them
        # off to measure the scalar baseline (serial prefetch, per-chunk GETs,
        # two-request footer opens).
        self.parallel_prefetch = parallel_prefetch
        self.coalesce_reads = coalesce_reads
        self.speculative_tail = speculative_tail
        # all TGBs in a run share layout, so after the first footer open the
        # window shrinks to the observed footer size (+margin) — keeps the
        # over-read negligible even for small TGBs
        self._window_hint: Optional[int] = None
        self.min_poll_interval_s = min_poll_interval_s
        # transient-fault tolerance: extra attempts per slice fetch before a
        # TransientStoreError / short read / CRC failure propagates
        self.read_retries = read_retries
        self._io_pool = io_pool
        self.stats = ConsumerStats(
            stats_instance or f"d{pos.dp_rank}c{pos.cp_rank}")
        self._stats_lock = threading.Lock()
        self._gets = _TimedGets(self)
        # optional flight recorder: this rank's counters become readable from
        # storage (lag/throughput diagnosis without touching the process)
        self._recorder = None
        if obs_snap_interval_s is not None:
            from repro_torch.obs.recorder import FlightRecorder
            self._recorder = FlightRecorder(ns, self.stats.metric_scope,
                                            interval_s=obs_snap_interval_s)
        self._footers: Dict[str, Tuple[TGBFooter, int]] = {}  # key -> (footer, size)
        self._footer_lock = threading.Lock()
        self.prefetch_depth = prefetch_depth
        self._prefetched: Dict[Tuple[int, int, int], bytes] = {}
        self._inflight: Dict[Tuple[int, int, int], Future] = {}
        self._prefetch_lock = threading.Lock()
        self._prefetch_thread: Optional[threading.Thread] = None
        self._prefetch_stop = threading.Event()
        self._last_prefetch_poll = float("-inf")

    @property
    def io_pool(self) -> IOPool:
        """The pool carrying this consumer's parallel GETs (process-shared by
        default so total in-flight requests stay bounded across ranks)."""
        if self._io_pool is None:
            self._io_pool = IOPool.default()
        return self._io_pool

    # -- cursor ---------------------------------------------------------------
    @property
    def cursor(self) -> Tuple[int, int]:
        """(V, S): manifest version being read + next global step index."""
        return (self.view.version, self.step)

    def restore_cursor(self, version: int, step: int) -> None:
        """Rollback/recovery: resume from a checkpointed cursor (§5.3). The
        watermark retention policy guarantees `version` is still readable."""
        self.view = self.manifests.load_view(version)
        self.step = step
        with self._prefetch_lock:
            self._prefetched.clear()
            # in-flight fetches for the old cursor will still deposit; the
            # overflow eviction drops anything below the restored cursor

    # -- manifest polling -------------------------------------------------------
    def poll(self) -> bool:
        """Probe for newer manifest versions; returns True if view advanced.
        A transient store failure during the probe reads as "no progress yet"
        — the next poll retries, which is all a prober needs."""
        self.stats.manifest_polls += 1
        try:
            latest = self.manifests.latest_version(hint=self.view.version)
            if latest > self.view.version:
                self.view = self.manifests.load_view(latest, base=self.view)
                return True
        except (TransientStoreError, NoSuchKey):
            # NoSuchKey here means a stale-read window hid a manifest the
            # probe just saw; the next poll re-reads it
            pass
        return False

    def _wait_for_step(self, step: int, timeout_s: Optional[float]) -> None:
        t0 = self.clock.now()
        poll_gap = 0.01
        while self.view.total_steps <= step:
            if not self.poll():
                if timeout_s is not None and self.clock.now() - t0 > timeout_s:
                    raise BatchTimeout(
                        f"step {step} not published after {timeout_s}s "
                        f"(total={self.view.total_steps})")
                self.clock.sleep(poll_gap)
                poll_gap = min(poll_gap * 1.5, 0.25)

    # -- footer cache ----------------------------------------------------------
    def _reader(self, key: str, size_hint: int) -> TGBReader:
        tail = self.speculative_tail
        if tail > 0 and self._window_hint is not None:
            tail = self._window_hint
        r = TGBReader(self._gets, key, object_size=size_hint,
                      speculative_tail=tail)
        with self._footer_lock:
            cached = self._footers.get(key)
        if cached is not None:
            r.set_cached_footer(*cached)
        return r

    def _cache_footer(self, key: str, reader: TGBReader) -> None:
        footer = reader.footer()
        with self._footer_lock:
            if key not in self._footers:
                self._footers[key] = (footer, reader.size)
                first = True
            else:
                first = False
        if first:
            with self._stats_lock:
                self.stats.footer_reads += 1
                # what the footer open actually fetched (speculative tail
                # window, or tail + exact footer in scalar mode)
                self.stats.bytes_fetched += reader.footer_overhead_bytes
                if self.speculative_tail > 0 and reader.footer_len > 0:
                    self._window_hint = min(
                        self.speculative_tail,
                        reader.footer_len + TAIL_BYTES + 256)

    # -- data reads --------------------------------------------------------------
    def _fetch_slice(self, tgb_step: int, d: int, c: int) -> bytes:
        desc = self.view.tgb_at_step(tgb_step)
        reader = self._reader(desc.object_key, desc.size_bytes)
        had_footer = reader._footer is not None
        if not had_footer:
            with trace_span("consumer.footer", cat="read"):
                self._cache_footer(desc.object_key, reader)
        if self.dense_read:
            blob = reader.read_full()
            with self._stats_lock:
                self.stats.bytes_fetched += len(blob)
            off, length, _crc = reader.footer().slice_entry(d, c)
            return blob[off:off + length]
        data = reader.read_slice(d, c, verify=self.verify_crc)
        with self._stats_lock:
            # window-served reads fetched nothing new (the bytes were already
            # charged as footer overhead)
            self.stats.bytes_fetched += reader.last_fetch_bytes
        return data

    def _fetch_span(self, tgb_step: int, d: int, c: int, span: int) -> bytes:
        """CP-shrink fast path: the whole span in one coalesced vectored GET."""
        desc = self.view.tgb_at_step(tgb_step)
        reader = self._reader(desc.object_key, desc.size_bytes)
        if reader._footer is None:
            with trace_span("consumer.footer", cat="read"):
                self._cache_footer(desc.object_key, reader)
        data = reader.read_slices(d, c, span, verify=self.verify_crc)
        with self._stats_lock:
            self.stats.bytes_fetched += reader.last_fetch_bytes
        return data

    def next_batch(self, timeout_s: Optional[float] = None) -> bytes:
        """Blocking read of this rank's slice for the next global step."""
        t0 = self.clock.now()
        layout = (self._tgb_dp(), self._tgb_cp())
        tgb_step, d, c = remap_step(self.step, self.pos, *layout)
        with trace_span("consumer.wait", cat="read", step=self.step):
            self._wait_for_step(tgb_step, timeout_s)
            if (self._tgb_dp(), self._tgb_cp()) != layout:
                # before the first view the layout was this rank's own
                # topology; the TGBs' is another: remap against theirs
                tgb_step, d, c = remap_step(self.step, self.pos,
                                            self._tgb_dp(), self._tgb_cp())
                self._wait_for_step(tgb_step, None if timeout_s is None else
                                    timeout_s - (self.clock.now() - t0))
        key3 = (tgb_step, d, c)
        with self._prefetch_lock:
            data = self._prefetched.pop(key3, None)
            fut = self._inflight.get(key3) if data is None else None
        if data is None and fut is not None:
            # a prefetch for exactly this step is in flight: ride it instead
            # of issuing a duplicate GET — but honor the remaining timeout
            # budget, and let a failed/slow worker fall through to the
            # direct fetch below
            remaining = None
            if timeout_s is not None:
                remaining = max(0.0, timeout_s - (self.clock.now() - t0))
            try:
                fut.result(timeout=remaining)
            except Exception:
                pass
            with self._prefetch_lock:
                data = self._prefetched.pop(key3, None)
        degraded = bool(getattr(self.store, "degraded", False))
        if degraded:
            self.stats.store_degraded = 1.0
            if data is not None:
                self.stats.degraded_batches += 1
        elif self.stats.store_degraded:
            self.stats.store_degraded = 0.0
        if data is not None:
            self.stats.prefetch_hits += 1
        else:
            self.stats.prefetch_misses += 1
            with trace_span("consumer.fetch", cat="read", step=self.step):
                try:
                    data = self._fetch_and_concat(tgb_step, d, c)
                except FAIL_FAST_ERRORS:
                    # breaker open / retry budget dry: the store is judged
                    # down. Don't crash the rank — ride out the outage within
                    # the batch deadline (a recovering store or a late
                    # prefetch deposit both unblock us).
                    data = self._outage_wait_fetch(key3, t0, timeout_s)
        self.stats.steps_consumed += 1
        self.stats.bytes_consumed += len(data)
        self.stats.read_latencies.append(self.clock.now() - t0)
        self.step += 1
        if self._recorder is not None:
            self._recorder.maybe_snap()
        return data

    def _outage_wait_fetch(self, key3: Tuple[int, int, int], t0: float,
                           timeout_s: Optional[float]) -> bytes:
        """Degraded-mode read: the circuit breaker is failing fast, so poll
        gently (no retry storm) until the breaker's half-open probe lets a
        fetch through or the batch deadline expires with ``BatchTimeout``."""
        tgb_step, d, c = key3
        gap = 0.01
        while True:
            self.stats.store_degraded = 1.0
            if timeout_s is not None and self.clock.now() - t0 > timeout_s:
                raise BatchTimeout(
                    f"step {tgb_step} unreadable for {timeout_s}s "
                    f"(store degraded)")
            self.clock.sleep(gap)
            gap = min(gap * 1.5, 0.25)
            with self._prefetch_lock:
                data = self._prefetched.pop(key3, None)
            if data is not None:
                self.stats.degraded_batches += 1
                return data
            try:
                return self._fetch_and_concat(tgb_step, d, c)
            except FAIL_FAST_ERRORS:
                continue  # still down; keep waiting

    def _tgb_dp(self) -> int:
        # the materialized layout; all TGBs in a run share D x C (enforced by
        # producers); fall back to consumer topology before first view.
        if self.view.tgbs:
            return self.view.tgbs[0].dp
        return self.pos.dp_size

    def _tgb_cp(self) -> int:
        if self.view.tgbs:
            return self.view.tgbs[0].cp
        return self.pos.cp_size

    def _fetch_and_concat(self, tgb_step: int, d: int, c: int) -> bytes:
        """Fetch slice (d, c); if CP shrank, fetch this rank's span of chunks
        (one coalesced vectored GET unless coalescing is disabled).

        The fetch is retried up to ``read_retries`` extra times on transient
        store failures, short reads, and CRC mismatches (all of which a flaky
        store manufactures): TGBs are immutable, so a clean re-read either
        succeeds or proves the object is really gone/corrupt. NoSuchKey is
        retryable too — a stale-read window can hide a just-committed TGB; a
        really-deleted one still fails after the bounded retries."""
        def count_retry(_attempt: int) -> None:
            with self._stats_lock:
                self.stats.read_retries += 1

        return retry_transient(
            lambda: self._fetch_once(tgb_step, d, c), self.clock,
            attempts=self.read_retries + 1, base_delay_s=0.005,
            retry_on=(TransientStoreError, TGBFormatError, NoSuchKey),
            on_retry=count_retry)

    def _fetch_once(self, tgb_step: int, d: int, c: int) -> bytes:
        tgb_cp = self._tgb_cp()
        span = max(1, tgb_cp // self.pos.cp_size) if tgb_cp > self.pos.cp_size else 1
        if span == 1:
            return self._fetch_slice(tgb_step, d, c)
        if self.coalesce_reads and not self.dense_read:
            return self._fetch_span(tgb_step, d, c, span)
        parts = [self._fetch_slice(tgb_step, d, c + i) for i in range(span)]
        return b"".join(parts)

    # -- prefetch -----------------------------------------------------------------
    def start_prefetch(self) -> None:
        if self._prefetch_thread is not None:
            return
        self._prefetch_stop.clear()
        self._prefetch_thread = threading.Thread(
            target=self._prefetch_loop, daemon=True,
            name=f"bw-prefetch-d{self.pos.dp_rank}c{self.pos.cp_rank}")
        self._prefetch_thread.start()

    def stop_prefetch(self) -> None:
        """Stop the prefetch loop and wait for the fetches it left in flight
        on the shared IO pool, so a stopped consumer sends no more GETs
        (nor records their latencies and spans) once this returns."""
        self._prefetch_stop.set()
        if self._prefetch_thread is not None:
            self._prefetch_thread.join(timeout=5)
            self._prefetch_thread = None
        with self._prefetch_lock:
            inflight = list(self._inflight.values())
        wait(inflight, timeout=5)

    def _evict_overflow(self) -> None:
        """Bound prefetch memory without starving the cursor. Caller holds
        the lock.

        Drop below-cursor leftovers first (a slow prefetch can land after
        ``next_batch`` already fetched that step directly; nothing will ever
        pop those keys), then evict farthest-ahead — never the slice about to
        be consumed (insertion-order eviction could drop exactly that one
        after a cursor restore)."""
        cap = self.prefetch_depth + 2
        if len(self._prefetched) <= cap:
            return
        try:
            cursor_tgb_step, _d, _c = remap_step(self.step, self.pos,
                                                 self._tgb_dp(), self._tgb_cp())
        except ValueError:
            cursor_tgb_step = None
        if cursor_tgb_step is not None:
            for key3 in [k for k in self._prefetched if k[0] < cursor_tgb_step]:
                if len(self._prefetched) <= cap:
                    break
                self._prefetched.pop(key3)
        while len(self._prefetched) > cap:
            self._prefetched.pop(max(self._prefetched))

    def _maybe_prefetch_poll(self) -> None:
        """Rate-limited manifest probe for the prefetch loop: a stalled
        producer must not turn the prefetcher into a manifest-hammering
        spin (each poll is a real HEAD/LIST against the store)."""
        now = self.clock.now()
        if now - self._last_prefetch_poll < self.min_poll_interval_s:
            return
        self._last_prefetch_poll = now
        self.poll()

    def _prefetch_one(self, key3: Tuple[int, int, int]) -> None:
        """IOPool worker body: fetch one slice span, deposit, retire. The
        in-flight entry is retired in a finally so an unexpected error can
        never wedge a prefetch slot (the step is simply retried later)."""
        tgb_step, d, c = key3
        data = None
        try:
            with trace_span("prefetch.fetch", cat="prefetch",
                            tgb_step=tgb_step):
                data = self._fetch_and_concat(tgb_step, d, c)
        except (StepUnavailable, NoSuchKey, TransientStoreError,
                TGBFormatError):
            # Protocol conditions only (trimmed/unpublished step, stale or
            # flaky store, corrupt read) — a bare KeyError is a bug and must
            # propagate. Not fatal: next_batch will fetch the step directly.
            pass
        finally:
            with self._prefetch_lock:
                self._inflight.pop(key3, None)
                if data is not None:
                    self._prefetched[key3] = data
                    self._evict_overflow()

    def _pump_prefetch(self) -> bool:
        """One scheduler pass: keep up to ``prefetch_depth`` fetches in
        flight (parallel mode) or fetch the next missing slice inline
        (scalar baseline). Returns True if any work was started."""
        progressed = False
        base = self.step
        for ahead in range(self.prefetch_depth):
            s = base + ahead
            try:
                tgb_step, d, c = remap_step(s, self.pos, self._tgb_dp(),
                                            self._tgb_cp())
            except ValueError:
                break
            key3 = (tgb_step, d, c)
            with self._prefetch_lock:
                known = key3 in self._prefetched or key3 in self._inflight
            if known:
                continue
            if self.view.total_steps <= tgb_step:
                self._maybe_prefetch_poll()
                if self.view.total_steps <= tgb_step:
                    break
            if self.parallel_prefetch:
                # only this thread inserts into _inflight, so checking
                # capacity and submitting under one lock section suffices
                with self._prefetch_lock:
                    if len(self._inflight) >= self.prefetch_depth:
                        break
                    self._inflight[key3] = self.io_pool.submit(
                        self._prefetch_one, key3)
                progressed = True
            else:
                try:
                    data = self._fetch_and_concat(tgb_step, d, c)
                except (StepUnavailable, NoSuchKey, TransientStoreError,
                        TGBFormatError):
                    break  # protocol conditions only; a bare KeyError raises
                with self._prefetch_lock:
                    self._prefetched[key3] = data
                    self._evict_overflow()
                progressed = True
        return progressed

    def _prefetch_loop(self) -> None:
        while not self._prefetch_stop.is_set():
            if not self._pump_prefetch():
                self.clock.sleep(0.005)
