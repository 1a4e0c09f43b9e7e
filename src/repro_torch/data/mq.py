"""Kafka-like centralized message-queue baseline (paper §7.1 'Kafka'); port
of ``repro.data.mq``, copied as it is but for its imports.

A faithful *simulation* of a centralized broker's structural properties — the
things the paper's evaluation attributes Kafka's behaviour to:

  * centralized append path: all producer requests serialize through the broker
    (a leader partition lock); aggregate ingest bandwidth is a broker-side
    constant shared by all producers, divided by the replication factor,
  * per-message size limit (``message.max.bytes``): strict-TGB mode puts one
    complete TGB in one message, so large payloads fail,
  * request timeout under queue-service load (``request.timeout.ms``),
  * record/offset consumption: a consumer fetches *whole messages*, so each of
    D ranks downloads the full TGB and discards (D-1)/D of it — D-fold read
    amplification (paper Fig. 3b).

The simulation runs on the same Clock/latency conventions as the object store so
fig5/fig6/fig10 comparisons are apples-to-apples.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from repro_torch.core.clock import Clock, SystemClock
from repro_torch.core.consumer import ConsumerStats
from repro_torch.core.errors import BatchTimeout
from repro_torch.obs.registry import COUNTER, StatsView


class MessageTooLarge(Exception):
    pass


class RequestTimeout(Exception):
    pass


@dataclass
class BrokerConfig:
    append_base_s: float = 0.004        # per-request broker overhead
    broker_ingest_Bps: float = 400e6    # aggregate leader ingest bandwidth
    broker_fetch_Bps: float = 800e6     # aggregate fetch bandwidth
    fetch_base_s: float = 0.003
    replication: int = 3                # synchronous replicas (acks=all)
    max_message_bytes: int = 64 * 1024 * 1024
    request_timeout_s: float = 30.0


class BrokerStats(StatsView):
    """Registry-backed broker counters (``broker.<instance>.*``)."""

    _FAMILY = "broker"
    _SPEC = {
        "appends": COUNTER,
        "append_failures_size": COUNTER,
        "append_failures_timeout": COUNTER,
        "bytes_in": COUNTER,
        "fetches": COUNTER,
        "bytes_out": COUNTER,
    }


class MQProducerStats(StatsView):
    """Registry-backed strict-TGB publisher counters, normalized to the tgb
    backend's producer field names (``producer.<instance>.*``) so fig5/fig6
    baseline comparisons report the same schema."""

    _FAMILY = "producer"
    _SPEC = {
        "tgbs_written": COUNTER,
        "bytes_written": COUNTER,
        "send_failures": COUNTER,  # broker rejections (size/timeout)
    }


class KafkaSimBroker:
    """Single-topic, single-partition leader (strict-TGB ordering requires a
    single totally ordered log — matching the paper's deployment mode)."""

    def __init__(self, config: BrokerConfig = BrokerConfig(),
                 clock: Optional[Clock] = None):
        self.cfg = config
        self.clock = clock or SystemClock()
        self._log: List[bytes] = []
        self._leader_lock = threading.Lock()
        self._fetch_lock = threading.Lock()
        self._readers_active = 0
        self.stats = BrokerStats()
        self._stats_lock = threading.Lock()

    # -- producer path ---------------------------------------------------------
    def append(self, message: bytes) -> int:
        """Append one message (one TGB in strict mode). Returns its offset.

        The leader lock is held for the full replicated transfer: this is what
        makes aggregate ingest throughput a broker constant rather than scaling
        with producer count.
        """
        if len(message) > self.cfg.max_message_bytes:
            with self._stats_lock:
                self.stats.append_failures_size += 1
            raise MessageTooLarge(f"{len(message)} > {self.cfg.max_message_bytes}")
        t_request = self.clock.now()
        acquired = self._leader_lock.acquire(
            timeout=self.cfg.request_timeout_s
            if isinstance(self.clock, SystemClock) else None)
        if not acquired:
            with self._stats_lock:
                self.stats.append_failures_timeout += 1
            raise RequestTimeout("leader busy")
        try:
            # waited too long in queue -> delivery timeout (peak-load failure
            # mode the paper hits on Qwen3-VL video payloads)
            if self.clock.now() - t_request > self.cfg.request_timeout_s:
                with self._stats_lock:
                    self.stats.append_failures_timeout += 1
                raise RequestTimeout("request expired in queue")
            xfer = self.cfg.append_base_s + \
                len(message) * self.cfg.replication / self.cfg.broker_ingest_Bps
            self.clock.sleep(xfer)
            self._log.append(bytes(message))
            offset = len(self._log) - 1
        finally:
            self._leader_lock.release()
        with self._stats_lock:
            self.stats.appends += 1
            self.stats.bytes_in += len(message)
        return offset

    # -- consumer path ---------------------------------------------------------
    def end_offset(self) -> int:
        with self._leader_lock:
            return len(self._log)

    def fetch(self, offset: int, timeout_s: Optional[float] = None) -> bytes:
        """Fetch the whole message at ``offset`` (record/offset abstraction: no
        sub-message range reads). Fetch bandwidth is shared among concurrent
        readers."""
        t0 = self.clock.now()
        while True:
            with self._leader_lock:
                have = len(self._log)
                msg = self._log[offset] if offset < have else None
            if msg is not None:
                break
            if timeout_s is not None and self.clock.now() - t0 > timeout_s:
                raise RequestTimeout(f"offset {offset} not available")
            self.clock.sleep(0.005)
        with self._fetch_lock:
            self._readers_active += 1
            readers = self._readers_active
        try:
            bw = self.cfg.broker_fetch_Bps / max(1, readers)
            self.clock.sleep(self.cfg.fetch_base_s + len(msg) / bw)
        finally:
            with self._fetch_lock:
                self._readers_active -= 1
        with self._stats_lock:
            self.stats.fetches += 1
            self.stats.bytes_out += len(msg)
        return msg


class KafkaTGBProducer:
    """Strict-TGB producer: one message carries exactly one complete TGB."""

    def __init__(self, broker: KafkaSimBroker, instance: str = "mq"):
        self.broker = broker
        self.stats = MQProducerStats(instance)

    def publish_tgb(self, tgb_blob: bytes) -> Optional[int]:
        try:
            off = self.broker.append(tgb_blob)
        except (MessageTooLarge, RequestTimeout):
            self.stats.send_failures += 1
            return None
        self.stats.tgbs_written += 1
        self.stats.bytes_written += len(tgb_blob)
        return off

    # -- legacy attribute aliases (pre-registry callers) --------------------
    @property
    def sent(self) -> int:
        return self.stats.tgbs_written

    @property
    def failed(self) -> int:
        return self.stats.send_failures

    @property
    def bytes_sent(self) -> int:
        return self.stats.bytes_written


class KafkaTGBConsumer:
    """Rank-side consumer: downloads the full TGB message, keeps only its own
    (d, c) slice — D x C read amplification by construction."""

    def __init__(self, broker: KafkaSimBroker, d: int, c: int, dp: int, cp: int):
        self.broker = broker
        self.d, self.c, self.dp, self.cp = d, c, dp, cp
        self.offset = 0
        # the same registry-backed surface the tgb consumer exposes, so
        # fig5/fig10 baseline comparisons report identical fields
        # (steps_consumed, bytes_fetched, read_retries, read_latencies, ...)
        self.stats = ConsumerStats(f"mq-d{d}c{c}")

    def next_batch(self, timeout_s: Optional[float] = None) -> bytes:
        """Blocking read of this rank's slice for the next offset.

        Same contract as ``repro_torch.core.Consumer.next_batch``: raises
        ``BatchTimeout`` if the message is not available within ``timeout_s``.
        """
        from repro_torch.core.tgb import TAIL_BYTES, TGBFooter, _TAIL

        t0 = self.broker.clock.now()
        try:
            msg = self.broker.fetch(self.offset, timeout_s=timeout_s)
        except RequestTimeout as e:
            raise BatchTimeout(
                f"offset {self.offset} not published after {timeout_s}s") from e
        self.offset += 1
        self.stats.bytes_fetched += len(msg)
        footer_len, _magic = _TAIL.unpack(msg[-TAIL_BYTES:])
        # whole-message fetch = one footer parse per message, no range reads
        self.stats.footer_reads += 1
        footer = TGBFooter.from_bytes(msg[-TAIL_BYTES - footer_len:-TAIL_BYTES])
        off, length, _crc = footer.slice_entry(self.d, self.c)
        out = msg[off:off + length]
        self.stats.steps_consumed += 1
        self.stats.bytes_consumed += len(out)
        self.stats.read_latencies.append(self.broker.clock.now() - t0)
        return out

    # -- legacy attribute aliases (pre-registry callers) --------------------
    @property
    def bytes_fetched(self) -> int:
        return self.stats.bytes_fetched

    @property
    def bytes_consumed(self) -> int:
        return self.stats.bytes_consumed

    @property
    def read_latencies(self):
        return self.stats.read_latencies

    @property
    def read_amplification(self) -> float:
        return self.stats.read_amplification
