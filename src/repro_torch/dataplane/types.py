"""Facade value types and client protocols.

Every backend speaks the same three nouns:

  * ``Topology``   — the consuming mesh's data-relevant shape (DP x CP) plus,
    optionally, the token-grid shape (``global_batch`` x ``seq_len``) that lets
    readers decode slice payloads into ``np.ndarray`` shards,
  * ``Batch``      — one rank's shard of one global batch, with its ``step``
    and manifest ``version`` attached,
  * ``Checkpoint`` — an opaque, string-encodable cursor token that round-trips
    the exactly-once save/restore flow across backends.
"""
from __future__ import annotations

import base64
from dataclasses import dataclass
from typing import (Dict, List, Mapping, Optional, Protocol, Tuple,
                    runtime_checkable)

from repro_torch.core import _msgpack as msgpack
import numpy as np

from repro_torch.core.errors import BatchTimeout

__all__ = [
    "Batch", "BatchReader", "BatchTimeout", "BatchWriter", "Checkpoint",
    "DataPlaneSession", "Topology", "UnsupportedOperation",
]


class UnsupportedOperation(RuntimeError):
    """The selected backend cannot perform this facade operation."""


@dataclass(frozen=True)
class Topology:
    """Data-relevant shape of the consuming mesh.

    ``dp`` x ``cp`` determines how each global batch is sliced (TP/PP ranks of
    one (d, c) group share a slice and simply reuse the same reader
    coordinates). When ``global_batch`` and ``seq_len`` are given, readers
    decode token-slice payloads into ``(global_batch/dp, seq_len/cp)`` int32
    arrays; otherwise batches carry raw bytes only.

    Attributes:
      dp: data-parallel degree (number of batch slices per global batch).
      cp: context-parallel degree (token-chunk slices per DP replica).
      global_batch: optional samples per global batch; must divide by ``dp``.
      seq_len: optional tokens per sample; must divide by ``cp``.

    Example::

        topo = Topology(dp=4, cp=2, global_batch=64, seq_len=4096)
        topo.world              # 8 (d, c) mesh positions
        topo.samples_per_slice  # 16 samples per DP slice
        topo.seq_per_rank       # 2048 tokens per CP chunk
    """

    dp: int = 1
    cp: int = 1
    global_batch: Optional[int] = None
    seq_len: Optional[int] = None

    def __post_init__(self):
        if self.dp < 1 or self.cp < 1:
            raise ValueError(f"dp/cp must be >= 1, got {self.dp}x{self.cp}")
        if self.global_batch is not None and self.global_batch % self.dp:
            raise ValueError(
                f"global_batch {self.global_batch} % dp {self.dp} != 0")
        if self.seq_len is not None and self.seq_len % self.cp:
            raise ValueError(f"seq_len {self.seq_len} % cp {self.cp} != 0")

    @property
    def world(self) -> int:
        return self.dp * self.cp

    @property
    def decodable(self) -> bool:
        return self.global_batch is not None and self.seq_len is not None

    @property
    def samples_per_slice(self) -> int:
        if self.global_batch is None:
            raise ValueError("Topology has no global_batch")
        return self.global_batch // self.dp

    @property
    def seq_per_rank(self) -> int:
        if self.seq_len is None:
            raise ValueError("Topology has no seq_len")
        return self.seq_len // self.cp


@dataclass(frozen=True)
class Batch:
    """One rank's shard of one global batch.

    ``payload`` is always present (the raw slice bytes). ``array`` is the
    decoded ``(samples_per_slice, seq_per_rank)`` int32 token grid when the
    session's Topology carries the grid shape and the payload matches it.
    ``version`` is the manifest version the batch became visible in (-1 for
    backends without a versioned control plane). ``stream`` names the source
    stream on a multi-stream session (None on single-stream sessions), in
    which case ``step`` is the *global* mixed step and ``version`` is that
    stream's manifest version.
    """

    payload: bytes
    step: int
    version: int
    dp_rank: int
    cp_rank: int
    array: Optional[np.ndarray] = None
    stream: Optional[str] = None

    @property
    def tokens(self) -> np.ndarray:
        if self.array is None:
            raise ValueError(
                "Batch payload is not a decodable token grid (open the "
                "session with Topology(global_batch=..., seq_len=...))")
        return self.array

    def __len__(self) -> int:
        return len(self.payload)

    @staticmethod
    def build(payload: bytes, step: int, version: int, dp_rank: int,
              cp_rank: int, topology: Topology,
              stream: Optional[str] = None) -> "Batch":
        arr = None
        if topology.decodable:
            want = topology.samples_per_slice * topology.seq_per_rank * 4
            if len(payload) == want:
                arr = np.frombuffer(payload, dtype=np.int32).reshape(
                    topology.samples_per_slice, topology.seq_per_rank)
        return Batch(payload=payload, step=step, version=version,
                     dp_rank=dp_rank, cp_rank=cp_rank, array=arr,
                     stream=stream)


#: Current token schema tag. v1 (``bwck1``) predates the RunManifest /
#: elastic-restore work and carried no capture topology; v2 adds it.
_CKPT_MAGIC = "bwck2"
_RETIRED_MAGICS = ("bwck1",)


@dataclass(frozen=True)
class Checkpoint:
    """Opaque exactly-once cursor token.

    For the tgb backend this is the paper's ``<V, S>`` consumer cursor
    (manifest version + next global step); for mq it is the next broker
    offset; for colocated it is the step counter. ``encode()`` yields a
    printable token safe to embed in a model checkpoint; ``open_dataplane``
    and ``reader.restore`` accept either the object or the encoded string.

    On a multi-stream session the token is *composite*: ``step`` is the global
    mixed step (the mix position — the schedule itself is recomputed from
    ``(weights, seed)``, never stored) and ``streams`` carries every stream's
    ``<V, S>`` cursor as ``(name, version, step)`` triples sorted by name.
    Single-stream tokens have ``streams=None`` and decode unchanged.

    ``topology`` records the capturing mesh's ``(dp, cp)``: the tgb backend
    uses it to remap the cursor onto a factor-resized mesh on restore, and
    the mq/colocated backends use it to *refuse* such a restore loudly
    instead of silently misreading slices. ``data_dp`` is the materialized
    TGB layout's DP degree at capture (the invariant unit elastic restores
    convert through) and ``mix_pos`` the composite token's mix position in
    those materialized units. All three are ``None`` on hand-built tokens,
    which restore positionally exactly as before.

    The wire format is versioned by a schema tag: tokens from a retired
    schema decode with a clear "re-checkpoint" error instead of a field
    ``KeyError`` deep inside a restore.

    Example — the save/restore round trip::

        token = reader.checkpoint().encode()       # str, store it anywhere
        ...                                        # crash, restart, rollback
        ckpt = Checkpoint.decode(token)            # or pass the str directly
        reader.restore(ckpt)                       # resumes exactly-once

    ``Checkpoint.coerce`` accepts a ``Checkpoint``, an encoded token string,
    or ``None`` — every facade entry point that takes a cursor uses it, so
    callers never need to decode by hand.
    """

    backend: str
    version: int
    step: int
    streams: Optional[Tuple[Tuple[str, int, int], ...]] = None
    topology: Optional[Tuple[int, int]] = None  # (dp, cp) at capture
    data_dp: Optional[int] = None   # materialized TGB layout DP at capture
    mix_pos: Optional[int] = None   # composite: mix position in data units

    @property
    def composite(self) -> bool:
        return self.streams is not None

    def stream_cursor(self, name: str) -> Tuple[int, int]:
        """(version, step) cursor of one named stream in a composite token."""
        for sname, v, s in self.streams or ():
            if sname == name:
                return (v, s)
        raise KeyError(f"checkpoint has no cursor for stream {name!r}")

    def encode(self) -> str:
        doc = {"m": _CKPT_MAGIC, "b": self.backend,
               "v": self.version, "s": self.step}
        if self.streams is not None:
            doc["st"] = [list(row) for row in self.streams]
        if self.topology is not None:
            doc["tp"] = list(self.topology)
        if self.data_dp is not None:
            doc["dd"] = self.data_dp
        if self.mix_pos is not None:
            doc["mu"] = self.mix_pos
        raw = msgpack.packb(doc)
        return base64.urlsafe_b64encode(raw).decode("ascii")

    @staticmethod
    def decode(token: str) -> "Checkpoint":
        try:
            d = msgpack.unpackb(base64.urlsafe_b64decode(token.encode("ascii")),
                                raw=False)
        except Exception as e:
            raise ValueError(
                f"not a dataplane Checkpoint token: {token!r}") from e
        magic = d.get("m") if isinstance(d, dict) else None
        if magic in _RETIRED_MAGICS:
            raise ValueError(
                f"checkpoint token uses the retired {magic!r} schema "
                f"(pre-RunManifest, no capture topology); current schema is "
                f"{_CKPT_MAGIC!r} — re-checkpoint the run to mint a "
                f"restorable token")
        if magic != _CKPT_MAGIC:
            raise ValueError(f"not a dataplane Checkpoint token: {token!r}")
        try:
            streams = None
            if d.get("st") is not None:
                streams = tuple(tuple(row) for row in d["st"])
            topology = tuple(d["tp"]) if d.get("tp") is not None else None
            return Checkpoint(backend=d["b"], version=d["v"], step=d["s"],
                              streams=streams, topology=topology,
                              data_dp=d.get("dd"), mix_pos=d.get("mu"))
        except Exception as e:
            raise ValueError(f"not a dataplane Checkpoint token: {token!r}") from e

    @staticmethod
    def coerce(obj: "Checkpoint | str | None") -> "Optional[Checkpoint]":
        if obj is None or isinstance(obj, Checkpoint):
            return obj
        if isinstance(obj, str):
            return Checkpoint.decode(obj)
        raise TypeError(f"expected Checkpoint or token string, got {type(obj)}")

    def as_tuple(self) -> Tuple[int, int]:
        return (self.version, self.step)


# ---------------------------------------------------------------------------
# Client protocols (structural — backends implement these shapes)
# ---------------------------------------------------------------------------

@runtime_checkable
class BatchReader(Protocol):
    """One (dp_rank, cp_rank) position's view of the batch stream.

    Structural protocol: every backend reader (``TGBBatchReader``,
    ``MQBatchReader``, ``ColocatedBatchReader``, ``MixedReader``) satisfies
    it, so training loops are written once against these four methods. A
    reader is single-threaded by contract — one reader per rank, ranks never
    coordinate (the manifest is the only shared state).
    """

    def next_batch(self, timeout_s: Optional[float] = None) -> Batch:
        """Blocking read of the next global batch's shard for this rank.
        Raises ``BatchTimeout`` if it is not available in time."""
        ...

    def checkpoint(self) -> Checkpoint:
        """Cursor token for the NEXT batch this reader would return."""
        ...

    def restore(self, ckpt: "Checkpoint | str") -> None:
        """Resume from a previously captured Checkpoint."""
        ...

    def close(self) -> None:
        ...


@runtime_checkable
class BatchWriter(Protocol):
    """One producer's write handle. Context-manager lifecycle: ``__enter__``
    recovers the durable stream offset (exactly-once restart), ``__exit__``
    finalizes (drains uncommitted batches) on clean exit.

    The restart contract: re-create the writer with the **same** writer id
    after a crash and re-enter the context — offsets the dead incarnation
    already committed are deduplicated by the manifest's producer state map,
    so replaying the input stream from the recovered offset is exactly-once
    by construction (rehearsed by ``repro.chaos``; see
    ``docs/OPERATIONS.md``).
    """

    def write(self, slices: Optional[Mapping[Tuple[int, int], bytes]] = None,
              *, uniform_slice_bytes: Optional[int] = None,
              num_samples: int = 0, token_count: int = 0) -> Optional[int]:
        """Publish one global batch (all D x C slices). Returns the stream
        offset it was written at (None if the backend dropped it)."""
        ...

    def write_tokens(self, tokens: np.ndarray) -> List[int]:
        """Feed a token stream; packs and publishes every completed global
        batch. Requires a decodable Topology. Returns offsets published."""
        ...

    def flush(self) -> bool:
        """Force a commit attempt of any pending batches."""
        ...

    def __enter__(self) -> "BatchWriter":
        ...

    def __exit__(self, exc_type, exc, tb) -> bool:
        ...


@runtime_checkable
class DataPlaneSession(Protocol):
    """A handle on one training run's data plane."""

    backend: str
    topology: Topology

    def writer(self, writer_id: str = "w0", **opts) -> BatchWriter:
        ...

    def reader(self, dp_rank: int = 0, cp_rank: int = 0, **opts) -> BatchReader:
        ...

    def close(self) -> None:
        ...
