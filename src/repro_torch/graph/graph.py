"""OpGraph: a DAG of named ops whose edges are streams.

Every op consumes one named stream and produces one named stream. Streams
produced by a ``PackOp`` are **materialized** — real TGB streams under the
run namespace, published through the ordinary producer commit protocol and
readable by any consumer. Streams produced by row ops are **virtual** edges:
they exist only as typing between fused stages, because a TGB stream is by
definition a packed token grid — the only way to materialize rows is to
pack them. The executor therefore fuses each materialized output's chain of
row ops back to its source stream and runs the whole chain in one
``DeriveWorker`` pass; fan-out (several ops reading one stream) simply
yields several chains.

``graph_hash()`` canonically hashes the whole structure (every op's id,
version, params hash, and wiring), so the same op in a different graph
derives under a different content address — lineage is pinned to the graph
that produced it, per the reproducible-pipelines design.

Port of ``repro.graph.graph``, copied as it is but for its imports.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Dict, List, Tuple

from repro_torch.graph.ops import PackOp, chain_params_hash, chain_signature
from repro_torch.graph.provenance import _canonical

__all__ = ["GraphError", "OpGraph", "DeriveChain"]


class GraphError(ValueError):
    """The op graph is structurally invalid (cycle, clash, dangling edge)."""


@dataclass(frozen=True)
class DeriveChain:
    """One executable unit: source stream -> fused row ops -> PackOp -> output."""

    source: str                 # input stream name (external to the graph)
    output: str                 # materialized output stream name
    ops: Tuple[object, ...]     # row ops in order, terminal PackOp last

    @property
    def pack(self) -> PackOp:
        return self.ops[-1]

    @property
    def signature(self) -> str:
        return chain_signature(self.ops)

    @property
    def params_hash(self) -> str:
        return chain_params_hash(self.ops)


class OpGraph:
    """A DAG of named ops; edges are stream names."""

    def __init__(self, name: str = "graph"):
        self.name = name
        # output stream name -> (op, source stream name)
        self._nodes: Dict[str, Tuple[object, str]] = {}

    def add(self, op, *, source: str, output: str) -> "OpGraph":
        """Wire ``op`` to consume stream ``source`` and produce ``output``."""
        if not source or not output:
            raise GraphError("source/output stream names must be non-empty")
        if source == output:
            raise GraphError(f"op {op.op_id!r}: source == output ({source!r})")
        if output in self._nodes:
            raise GraphError(f"stream {output!r} already has a producer op "
                             f"({self._nodes[output][0].op_id!r})")
        self._nodes[output] = (op, source)
        self._check_acyclic()
        return self

    def _check_acyclic(self) -> None:
        for start in self._nodes:
            seen = set()
            cur = start
            while cur in self._nodes:
                if cur in seen:
                    raise GraphError(f"cycle through stream {cur!r}")
                seen.add(cur)
                cur = self._nodes[cur][1]

    # -- structure queries ----------------------------------------------------
    @property
    def sources(self) -> List[str]:
        """Stream names consumed but never produced: the graph's inputs."""
        produced = set(self._nodes)
        return sorted({src for _, src in self._nodes.values()}
                      - produced)

    @property
    def outputs(self) -> List[str]:
        """Materialized output stream names (produced by a PackOp)."""
        return sorted(out for out, (op, _) in self._nodes.items()
                      if isinstance(op, PackOp))

    def chain(self, output: str) -> DeriveChain:
        """Resolve the fused chain producing materialized stream ``output``."""
        if output not in self._nodes:
            raise GraphError(f"no op produces stream {output!r}")
        ops: List[object] = []
        cur = output
        while cur in self._nodes:
            op, src = self._nodes[cur]
            if ops and isinstance(op, PackOp):
                raise GraphError(
                    f"stream {cur!r} is materialized (PackOp output) but is "
                    f"consumed by a fused row chain; derive it with its own "
                    f"worker and feed the downstream graph from it")
            ops.append(op)
            cur = src
        ops.reverse()
        if not isinstance(ops[-1], PackOp):
            raise GraphError(
                f"stream {output!r} is a virtual (row) edge; only PackOp "
                f"outputs materialize — terminate the chain with a PackOp")
        return DeriveChain(source=cur, output=output, ops=tuple(ops))

    def chains(self) -> List[DeriveChain]:
        return [self.chain(out) for out in self.outputs]

    # -- identity -------------------------------------------------------------
    def graph_hash(self) -> str:
        """Canonical hash of the whole DAG structure + every op's identity."""
        doc = {
            "name": self.name,
            "nodes": {
                out: {
                    "op": f"{op.op_id}@{op.version}",
                    "params": chain_params_hash([op]),
                    "source": src,
                }
                for out, (op, src) in self._nodes.items()
            },
        }
        return hashlib.sha256(_canonical(doc)).hexdigest()

    def __repr__(self) -> str:
        edges = ", ".join(f"{src}-[{op.op_id}]->{out}"
                          for out, (op, src) in sorted(self._nodes.items()))
        return f"OpGraph({self.name!r}: {edges})"
