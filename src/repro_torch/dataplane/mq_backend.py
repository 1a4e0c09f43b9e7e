"""`mq` backend: the centralized message-queue baseline behind the facade
(port of ``repro.dataplane.mq_backend``, copied as it is but for its imports).

One broker message carries one complete TGB blob (strict-TGB mode); a reader
fetches whole messages and keeps its own (d, c) slice — the record/offset
abstraction's D x C read amplification is preserved by construction, which is
exactly what makes facade-level benchmarks apples-to-apples.

  writer  -> ``KafkaTGBProducer`` (TGBBuilder blob -> broker.append)
  reader  -> ``KafkaTGBConsumer`` (whole-message fetch + local slice)
  Checkpoint("mq", -1, offset) -> the next broker offset

The broker has no manifest, so ``version`` is always -1 and there is no
watermark/reclamation lifecycle. Exactly-once writer recovery is offset-based:
``__enter__`` records the broker's end offset as the recovery point, and a
deterministic replay from sequence 0 deduplicates every sequence below it
(exact for the single-writer-per-log deployment the strict-TGB mode models;
with interleaved writers the broker offset over-counts and recovery degrades
to at-most-once for the interleaved span — the record/offset abstraction has
no per-producer durable state to do better, which is the paper's point).
"""
from __future__ import annotations

from typing import List, Optional

from repro_torch.core.tgb import TGBBuilder, build_uniform_tgb
from repro_torch.data.mq import (BrokerConfig, KafkaSimBroker,
                                 KafkaTGBConsumer, KafkaTGBProducer)
from repro_torch.dataplane._base import PackingWriterMixin, SessionBase
from repro_torch.dataplane.types import (Batch, Checkpoint, Topology,
                                         UnsupportedOperation)


class MQWriter(PackingWriterMixin):
    """Context-managed strict-TGB publisher."""

    def __init__(self, broker: KafkaSimBroker, topology: Topology,
                 writer_id: str):
        self.broker = broker
        self.topology = topology
        self.writer_id = writer_id
        self.kp = KafkaTGBProducer(broker, instance=writer_id)
        self.next_seq = 0
        self.recovered_offset = 0

    def __enter__(self) -> "MQWriter":
        # a broker log is the durable state: resume after the last appended
        # message (no per-producer manifest offsets to recover)
        self.recovered_offset = self.broker.end_offset()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False  # appends are synchronous; nothing to drain

    def write(self, slices=None, *, uniform_slice_bytes=None,
              num_samples: int = 0, token_count: int = 0) -> Optional[int]:
        seq = self.next_seq
        if seq < self.recovered_offset:
            # exactly-once replay dedup: this sequence is already in the log
            self.next_seq = seq + 1
            return None
        tgb_id = f"{self.writer_id}-{seq:012d}"
        if slices is not None:
            b = TGBBuilder(tgb_id, self.topology.dp, self.topology.cp,
                           self.writer_id, seq, num_samples=num_samples,
                           token_count=token_count)
            for (d, c), payload in slices.items():
                b.add_slice(d, c, payload)
            blob = b.build()
        else:
            blob = build_uniform_tgb(tgb_id, self.topology.dp,
                                     self.topology.cp, self.writer_id, seq,
                                     uniform_slice_bytes or 1024,
                                     num_samples=num_samples,
                                     token_count=token_count)
        self.next_seq = seq + 1
        return self.kp.publish_tgb(blob)  # None if the broker dropped it

    def flush(self) -> bool:
        return True

    def seek(self, offset: int) -> None:
        """Rewind for deterministic replay (sequences below the recovery
        point are deduplicated by ``write``)."""
        self.next_seq = offset

    @property
    def stats(self):
        return self.kp.stats


class MQBatchReader:
    """Facade reader over the whole-message record consumer."""

    def __init__(self, broker: KafkaSimBroker, topology: Topology,
                 dp_rank: int, cp_rank: int,
                 resume: "Checkpoint | str | None" = None):
        self.topology = topology
        self.consumer = KafkaTGBConsumer(broker, dp_rank, cp_rank,
                                         topology.dp, topology.cp)
        self.dp_rank, self.cp_rank = dp_rank, cp_rank
        ckpt = Checkpoint.coerce(resume)
        if ckpt is not None:
            self.restore(ckpt)

    def next_batch(self, timeout_s: Optional[float] = None) -> Batch:
        step = self.consumer.offset
        payload = self.consumer.next_batch(timeout_s=timeout_s)
        return Batch.build(payload, step=step, version=-1,
                           dp_rank=self.dp_rank, cp_rank=self.cp_rank,
                           topology=self.topology)

    def checkpoint(self) -> Checkpoint:
        return Checkpoint("mq", version=-1, step=self.consumer.offset,
                          topology=(self.topology.dp, self.topology.cp))

    def restore(self, ckpt: "Checkpoint | str") -> None:
        ckpt = Checkpoint.coerce(ckpt)
        if ckpt.backend != "mq":
            raise ValueError(f"cannot restore a {ckpt.backend!r} checkpoint "
                             f"on an mq reader")
        here = (self.topology.dp, self.topology.cp)
        if ckpt.topology is not None and tuple(ckpt.topology) != here:
            # a broker offset has no (step, rank) -> (offset, slice) remap:
            # reinterpreting it under a different D x C silently misreads
            # slices, so refuse instead
            raise UnsupportedOperation(
                f"mq backend cannot restore a checkpoint captured at "
                f"dp={ckpt.topology[0]} cp={ckpt.topology[1]} onto a "
                f"dp={here[0]} cp={here[1]} reader: the record/offset "
                f"abstraction has no topology remap. Factor DP resize is "
                f"supported only by the tgb backend's elastic restore path "
                f"(TGBBatchReader.restore / TrainSession.resume)")
        self.consumer.offset = ckpt.step

    def close(self) -> None:
        pass

    @property
    def stats(self):
        return self.consumer.stats


class MQSession(SessionBase):
    backend = "mq"

    def __init__(self, broker: Optional[KafkaSimBroker], topology: Topology, *,
                 namespace: str = "runs/dataplane",
                 resume: "Checkpoint | str | None" = None,
                 broker_config: Optional[BrokerConfig] = None, clock=None):
        if broker is None:
            broker = KafkaSimBroker(broker_config or BrokerConfig(),
                                    clock=clock)
        if not isinstance(broker, KafkaSimBroker):
            raise TypeError(f"mq backend needs a KafkaSimBroker target, got "
                            f"{type(broker).__name__}")
        self.broker = broker
        self.topology = topology
        self.namespace = namespace  # informational; the broker log is global
        self._resume = Checkpoint.coerce(resume)
        self._readers: List[MQBatchReader] = []

    def writer(self, writer_id: str = "w0", **_opts) -> MQWriter:
        return MQWriter(self.broker, self.topology, writer_id)

    def reader(self, dp_rank: int = 0, cp_rank: int = 0, *,
               resume: "Checkpoint | str | None" = None,
               **_opts) -> MQBatchReader:
        r = MQBatchReader(self.broker, self.topology, dp_rank, cp_rank,
                          resume=resume if resume is not None
                          else self._resume)
        self._readers.append(r)
        return r

    def close(self) -> None:
        self._readers.clear()


def _factory(target, topology, **opts) -> MQSession:
    return MQSession(target, topology, **opts)
