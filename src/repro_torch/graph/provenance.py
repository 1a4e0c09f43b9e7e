"""Canonical provenance records for derived TGBs.

Every TGB a ``DeriveWorker`` publishes carries one of these records — in its
footer (self-describing object) and in its manifest descriptor (auditable
without opening the object). The record pins everything that determined the
output bytes:

  * the source stream name and the exact source TGB ids consumed,
  * the op chain that transformed them (``op_id@version`` per stage),
  * a hash of every op's parameters,
  * the hash of the whole graph structure (so moving an op between graphs
    changes the address), and
  * the output index within the derive quantum (one quantum can emit
    several packed outputs).

``Provenance.content_hash()`` is a canonical hash over all of it. Derived
TGB objects are *content-addressed* by that hash (it becomes the key token),
which is what turns exactly-once derivation into a storage property: a
re-run or a restarted worker recomputes the same record, lands on the same
key, finds the object already present, and skips the work.

Port of ``repro.graph.provenance``, copied as it is but for its imports:
the canonical bytes come from the port's ``core._msgpack``, which writes
what msgpack 1.x writes for these documents, so a record hashes to the
same content address in both packages.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

from repro_torch.core import _msgpack as msgpack

__all__ = ["PROV_SCHEMA", "Provenance", "params_hash"]

#: wire-format schema tag carried inside every record; bump on changes
PROV_SCHEMA = 1


def _canonical(doc) -> bytes:
    """Deterministic msgpack: dict keys sorted recursively."""
    if isinstance(doc, dict):
        doc = {k: doc[k] for k in sorted(doc)}
        return msgpack.packb(
            {k: msgpack.unpackb(_canonical(v), raw=False)
             for k, v in doc.items()}, use_bin_type=True)
    if isinstance(doc, (list, tuple)):
        return msgpack.packb(
            [msgpack.unpackb(_canonical(v), raw=False) for v in doc],
            use_bin_type=True)
    return msgpack.packb(doc, use_bin_type=True)


def params_hash(params: Optional[dict]) -> str:
    """Canonical hash of an op's parameter dict (order-insensitive)."""
    return hashlib.sha256(_canonical(params or {})).hexdigest()


@dataclass(frozen=True)
class Provenance:
    """The canonical derivation record of one derived TGB."""

    src_stream: str                  # source stream name under the run ns
    src_tgb_ids: Tuple[str, ...]     # exact source TGBs this output drew from
    op: str                          # fused chain signature, "filter@1>pack@1"
    params: str                      # params_hash over every stage's params
    graph: str                       # OpGraph.graph_hash()
    out_index: int                   # output ordinal within the derive quantum

    def to_wire(self) -> dict:
        """The plain dict embedded in TGB footers / manifest descriptors."""
        return {
            "schema": PROV_SCHEMA,
            "src_stream": self.src_stream,
            "src": list(self.src_tgb_ids),
            "op": self.op,
            "params": self.params,
            "graph": self.graph,
            "k": self.out_index,
        }

    @staticmethod
    def from_wire(doc: dict) -> "Provenance":
        if not isinstance(doc, dict) or "schema" not in doc:
            raise ValueError("provenance record carries no schema tag")
        if doc["schema"] != PROV_SCHEMA:
            raise ValueError(
                f"provenance schema {doc['schema']!r} is not supported by "
                f"this build (expected {PROV_SCHEMA})")
        try:
            return Provenance(
                src_stream=doc["src_stream"],
                src_tgb_ids=tuple(doc["src"]),
                op=doc["op"], params=doc["params"], graph=doc["graph"],
                out_index=doc["k"])
        except KeyError as e:
            raise ValueError(f"provenance record missing field {e}") from e

    def content_hash(self) -> str:
        """The content address of the derived output this record describes:
        a pure function of {sources, op id + version, params, graph, index}.
        Deterministic derivation makes equal hashes imply equal bytes."""
        return hashlib.sha256(_canonical(self.to_wire())).hexdigest()

    def content_token(self) -> str:
        """The object-key token form of the content hash (fits the standard
        ``<offset>-<token>.tgb`` key shape every tool already parses)."""
        return self.content_hash()[:16]
