"""The op vocabulary of the derive graph.

Ops transform *rows* of the token grid: a source TGB decodes to a
``(global_batch, seq_len)`` int32 array and each row flows through the chain
as one record. Row ops (``MapOp``/``FilterOp``/``DedupOp``) are pure
functions of their input rows — that determinism is what makes derived
outputs content-addressable. ``PackOp`` is the terminal, materializing
stage: it re-packs surviving rows into output global batches through
``GlobalBatchPacker`` (possibly at a different D x C / grid shape) and pads
the final partial batch via ``flush(pad_token)`` when the source stream is
exhausted.

A model-scored stage (quality filter, reward scorer) is just a ``BatchOp``
whose ``process`` calls the model; ``version`` and ``params`` pin the model
identity so a weight bump re-derives under a new content address.

Port of ``repro.graph.ops``, copied as it is but for its imports.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Protocol, runtime_checkable

import hashlib

import numpy as np

from repro_torch.data.packing import GlobalBatchPacker, PackedBatch
from repro_torch.graph.provenance import params_hash

__all__ = ["BatchOp", "RowOp", "MapOp", "FilterOp", "DedupOp", "PackOp"]


@runtime_checkable
class BatchOp(Protocol):
    """Structural protocol every graph stage satisfies.

    ``op_id`` names the stage, ``version`` pins its implementation (bump it
    whenever the transformation changes — outputs re-derive under a new
    content address), ``params()`` is the canonicalized configuration that
    feeds the provenance hash.
    """

    op_id: str
    version: int

    def params(self) -> dict:
        ...

    def process(self, rows: np.ndarray) -> np.ndarray:
        """Transform a block of rows; returns the surviving/transformed rows
        (row ops only — ``PackOp`` materializes instead)."""
        ...


class RowOp:
    """Base for row-wise stages: identity process, shared signature bits."""

    def __init__(self, op_id: str, version: int = 1,
                 params: Optional[dict] = None):
        if not op_id or "/" in op_id or ">" in op_id:
            raise ValueError(f"bad op_id {op_id!r} (no '/', no '>')")
        self.op_id = op_id
        self.version = version
        self._params = dict(params or {})

    @property
    def signature(self) -> str:
        return f"{self.op_id}@{self.version}"

    def params(self) -> dict:
        return dict(self._params)

    def process(self, rows: np.ndarray) -> np.ndarray:
        return rows

    def reset(self) -> None:
        """Clear any per-quantum state (called at each derive-quantum
        boundary so replays are deterministic from the committed cursor)."""

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self.signature})"


class MapOp(RowOp):
    """Apply ``fn(rows) -> rows`` to every block (vectorized row map).

    ``fn`` must be pure and length-preserving; anything it is parameterized
    by belongs in ``params`` so the content address tracks it.
    """

    def __init__(self, op_id: str, fn: Callable[[np.ndarray], np.ndarray],
                 version: int = 1, params: Optional[dict] = None):
        super().__init__(op_id, version, params)
        self.fn = fn

    def process(self, rows: np.ndarray) -> np.ndarray:
        out = np.asarray(self.fn(rows))
        if out.shape != rows.shape:
            raise ValueError(
                f"{self.signature}: map must preserve the row grid shape, "
                f"got {rows.shape} -> {out.shape}")
        return out


class FilterOp(RowOp):
    """Keep rows where ``predicate(rows) -> bool mask`` is True."""

    def __init__(self, op_id: str, predicate: Callable[[np.ndarray], np.ndarray],
                 version: int = 1, params: Optional[dict] = None):
        super().__init__(op_id, version, params)
        self.predicate = predicate

    def process(self, rows: np.ndarray) -> np.ndarray:
        mask = np.asarray(self.predicate(rows), dtype=bool)
        if mask.shape != (rows.shape[0],):
            raise ValueError(
                f"{self.signature}: predicate must yield one bool per row, "
                f"got shape {mask.shape} for {rows.shape[0]} rows")
        return rows[mask]


class DedupOp(RowOp):
    """Drop exact-duplicate rows (first occurrence wins).

    Dedup scope is one *derive quantum* (the window of source TGBs between
    two cursor commits): the seen-set resets at every quantum boundary, so a
    worker replaying from its committed cursor reproduces the output
    byte-identically without any persisted dedup state.
    """

    def __init__(self, op_id: str = "dedup", version: int = 1,
                 params: Optional[dict] = None):
        super().__init__(op_id, version, params)
        self._seen: set = set()

    def reset(self) -> None:
        self._seen.clear()

    def process(self, rows: np.ndarray) -> np.ndarray:
        keep = []
        for i in range(rows.shape[0]):
            h = hashlib.sha256(np.ascontiguousarray(rows[i]).tobytes()).digest()
            if h in self._seen:
                continue
            self._seen.add(h)
            keep.append(i)
        if len(keep) == rows.shape[0]:
            return rows
        return rows[keep]


class PackOp(RowOp):
    """Terminal stage: re-pack surviving rows into output global batches.

    Wraps ``data.packing.GlobalBatchPacker``. The output grid shape and
    D x C layout are the op's parameters (they determine output bytes, so
    they feed the content address). ``flush()`` pads and emits the final
    partial batch — invoked by the worker at every derive-quantum boundary
    (which includes source-stream exhaustion), keeping packer state from
    ever crossing a cursor commit.
    """

    def __init__(self, op_id: str, global_batch: int, seq_len: int,
                 dp: int = 1, cp: int = 1, pad_token: int = 0,
                 version: int = 1):
        super().__init__(op_id, version, params={
            "global_batch": global_batch, "seq_len": seq_len,
            "dp": dp, "cp": cp, "pad_token": pad_token})
        self.global_batch = global_batch
        self.seq_len = seq_len
        self.dp = dp
        self.cp = cp
        self.pad_token = pad_token
        self._packer: Optional[GlobalBatchPacker] = None

    def _ensure(self) -> GlobalBatchPacker:
        if self._packer is None:
            self._packer = GlobalBatchPacker(self.global_batch, self.seq_len,
                                             self.dp, self.cp)
        return self._packer

    def reset(self) -> None:
        self._packer = None

    def pack_rows(self, rows: np.ndarray) -> List[PackedBatch]:
        if rows.size == 0:
            return []
        # one packer "sample" per surviving source row: num_samples on the
        # output TGB counts contributing source rows
        return self._ensure().add_tokens(rows.ravel(), samples=rows.shape[0])

    def flush(self) -> Optional[PackedBatch]:
        """Source exhausted (or quantum boundary): pad + emit the remainder
        via the packer's end-of-stream flush semantics."""
        if self._packer is None:
            return None
        return self._packer.flush(pad_token=self.pad_token)


def chain_signature(ops) -> str:
    """The fused chain's identity string: ``"filter@1>pack@2"``."""
    return ">".join(op.signature for op in ops)


def chain_params_hash(ops) -> str:
    """One canonical hash over every stage's parameters, keyed by stage."""
    return params_hash({op.signature: op.params() for op in ops})
