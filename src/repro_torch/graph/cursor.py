"""DeriveCursor: the worker's durable progress record.

Mirrors the ``RunManifest`` commit style exactly: small, versioned,
conditionally-written entries at ``<output stream>/derive/<seq>.dc``, each
binding in **one object-store commit**:

  * the source cursor (source stream steps consumed through), and
  * the output sequence (producer offsets published through).

A crash anywhere between derive and cursor commit replays the window from
the last committed entry: already-uploaded outputs are found by content
address (upload skipped), already-committed offsets are deduplicated by the
manifest's producer state map — so the replay is deterministic and
exactly-once with no coordination. Monotone sequence numbers are claimed by
conditional put; a zombie incarnation that lost a race is fenced by the
regression check (its source cursor would roll progress backward).

Port of ``repro.graph.cursor``, copied as it is but for its imports
(msgpack is the port's ``core._msgpack``; the bytes are msgpack's).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import List, Optional

from repro_torch.core import _msgpack as msgpack

from repro_torch.core.objectstore import Namespace, NoSuchKey

__all__ = ["DERIVE_SCHEMA", "DERIVE_DIR", "DeriveCursor", "DeriveCursorError",
           "DeriveCursorStore"]

#: wire-format schema tag; bump on incompatible changes
DERIVE_SCHEMA = 1
#: directory component under the output stream namespace
DERIVE_DIR = "derive"


class DeriveCursorError(ValueError):
    """A derive cursor entry is missing, malformed, or from an unknown schema."""


@dataclass(frozen=True)
class DeriveCursor:
    """One committed derive-progress record."""

    seq: int            # monotone commit sequence (the object key)
    src_step: int       # source stream steps consumed through (exclusive)
    out_seq: int        # next producer offset the worker will publish at
    graph: str          # OpGraph.graph_hash() this progress belongs to
    op: str             # fused chain signature, e.g. "filter@1>pack@1"
    worker_id: str = "" # last incarnation to commit (diagnostic only)

    def pack(self) -> bytes:
        return msgpack.packb({
            "schema": DERIVE_SCHEMA,
            "seq": self.seq,
            "src": self.src_step,
            "out": self.out_seq,
            "graph": self.graph,
            "op": self.op,
            "worker": self.worker_id,
        }, use_bin_type=True)

    @staticmethod
    def unpack(raw: bytes) -> "DeriveCursor":
        try:
            d = msgpack.unpackb(raw, raw=False)
        except Exception as e:
            raise DeriveCursorError(
                f"undecodable derive cursor: {type(e).__name__}: {e}") from e
        if not isinstance(d, dict) or "schema" not in d:
            raise DeriveCursorError("derive cursor carries no schema tag")
        if d["schema"] != DERIVE_SCHEMA:
            raise DeriveCursorError(
                f"derive cursor schema {d['schema']!r} is not supported by "
                f"this build (expected {DERIVE_SCHEMA})")
        try:
            return DeriveCursor(seq=d["seq"], src_step=d["src"],
                                out_seq=d["out"], graph=d["graph"],
                                op=d["op"], worker_id=d.get("worker", ""))
        except KeyError as e:
            raise DeriveCursorError(f"derive cursor missing field {e}") from e


class DeriveCursorStore:
    """Reads and conditionally commits derive cursors of one derived stream."""

    def __init__(self, ns: Namespace):
        self.ns = ns
        self.store = ns.store

    def key(self, seq: int) -> str:
        return self.ns.key(DERIVE_DIR, f"{seq:08d}.dc")

    def seqs(self) -> List[int]:
        out = []
        for key in self.store.list(self.ns.key(DERIVE_DIR)):
            try:
                out.append(int(key.rsplit("/", 1)[-1].split(".")[0]))
            except ValueError:
                pass
        return sorted(out)

    def read(self, seq: int) -> DeriveCursor:
        try:
            raw = self.store.get(self.key(seq))
        except (KeyError, NoSuchKey) as e:
            raise DeriveCursorError(f"no derive cursor seq={seq}") from e
        return DeriveCursor.unpack(raw)

    def latest(self) -> Optional[DeriveCursor]:
        seqs = self.seqs()
        if not seqs:
            return None
        return self.read(seqs[-1])

    def commit(self, dc: DeriveCursor) -> bool:
        """Claim ``dc.seq`` with a conditional put. False = another worker
        incarnation won that sequence number."""
        return self.store.put_if_absent(self.key(dc.seq), dc.pack())

    def append(self, *, src_step: int, out_seq: int, graph: str, op: str,
               worker_id: str = "", max_attempts: int = 16) -> DeriveCursor:
        """Commit the next entry (monotone seq claim + regression fencing).

        A candidate whose source cursor sits behind the committed head is a
        zombie incarnation resurfacing after a replacement advanced the
        stream — refused, exactly like a regressive RunManifest entry.
        """
        candidate = DeriveCursor(seq=0, src_step=src_step, out_seq=out_seq,
                                 graph=graph, op=op, worker_id=worker_id)
        for _ in range(max_attempts):
            seqs = self.seqs()
            seq = (seqs[-1] + 1) if seqs else 0
            if seqs:
                head = self.read(seqs[-1])
                if head.graph != graph:
                    raise DeriveCursorError(
                        f"derive cursor chain belongs to graph "
                        f"{head.graph[:12]}…, not {graph[:12]}… — bump the op "
                        f"version and derive into a fresh stream instead of "
                        f"mixing graphs in one output")
                if candidate.src_step < head.src_step:
                    raise DeriveCursorError(
                        f"refusing to commit a regressive derive cursor: "
                        f"candidate src_step {candidate.src_step} < committed "
                        f"{head.src_step} (seq {head.seq}) — is a replaced "
                        f"worker incarnation still running?")
            dc = replace(candidate, seq=seq)
            if self.commit(dc):
                return dc
        raise DeriveCursorError(
            f"could not claim a derive cursor sequence number after "
            f"{max_attempts} attempts (is another worker committing?)")
