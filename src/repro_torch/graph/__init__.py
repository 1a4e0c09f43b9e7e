"""Derived-stream transformation DAG with content-addressed provenance.

``OpGraph`` wires ops (``MapOp``/``FilterOp``/``DedupOp``/``PackOp``) into a
DAG whose edges are streams; ``DeriveWorker`` executes one fused chain,
consuming source TGBs through the ordinary consumer read path and publishing
derived TGBs through the ordinary producer commit protocol. Every derived
TGB carries a canonical ``Provenance`` record and is content-addressed by
its hash; worker progress is one conditional-put ``DeriveCursor`` per
window. Together these make re-derivation exactly-once as a *storage*
property: replays find their outputs already present and skip them.

Port of ``repro.graph``, copied as it is but for its imports.
"""
from repro_torch.graph.cursor import (DERIVE_DIR, DERIVE_SCHEMA, DeriveCursor,
                                DeriveCursorError, DeriveCursorStore)
from repro_torch.graph.graph import DeriveChain, GraphError, OpGraph
from repro_torch.graph.ops import (BatchOp, DedupOp, FilterOp, MapOp, PackOp, RowOp,
                             chain_params_hash, chain_signature)
from repro_torch.graph.provenance import PROV_SCHEMA, Provenance, params_hash
from repro_torch.graph.worker import DeriveStats, DeriveWorker

__all__ = [
    "BatchOp", "RowOp", "MapOp", "FilterOp", "DedupOp", "PackOp",
    "chain_signature", "chain_params_hash",
    "OpGraph", "DeriveChain", "GraphError",
    "Provenance", "PROV_SCHEMA", "params_hash",
    "DeriveCursor", "DeriveCursorStore", "DeriveCursorError",
    "DERIVE_SCHEMA", "DERIVE_DIR",
    "DeriveWorker", "DeriveStats",
]
