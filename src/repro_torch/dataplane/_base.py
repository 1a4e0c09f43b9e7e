"""Shared backend scaffolding: packing writer mixin + session base."""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from repro_torch.data.packing import GlobalBatchPacker
from repro_torch.dataplane.types import Topology, UnsupportedOperation


class PackingWriterMixin:
    """Gives a backend writer ``write_tokens`` on top of its ``write``.

    Requires ``self.topology`` (a decodable Topology) and ``self.write``.
    """

    topology: Topology
    _packer: Optional[GlobalBatchPacker] = None

    def _ensure_packer(self) -> GlobalBatchPacker:
        if self._packer is None:
            t = self.topology
            if not t.decodable:
                raise UnsupportedOperation(
                    "write_tokens needs Topology(global_batch=..., "
                    "seq_len=...) so the writer can pack the stream")
            self._packer = GlobalBatchPacker(t.global_batch, t.seq_len,
                                             t.dp, t.cp)
        return self._packer

    def write_tokens(self, tokens: np.ndarray) -> List[int]:
        packer = self._ensure_packer()
        offsets: List[int] = []
        for batch in packer.add_tokens(np.asarray(tokens)):
            off = self.write(batch.slices, num_samples=batch.num_samples,
                             token_count=batch.token_count)
            if off is not None:
                offsets.append(off)
        return offsets

    def flush_tokens(self, pad_token: int = 0) -> Optional[int]:
        """End-of-stream: publish the packer's buffered remainder as one
        final batch padded with ``pad_token`` (None if nothing is buffered)."""
        if self._packer is None:
            return None
        batch = self._packer.flush(pad_token=pad_token)
        if batch is None:
            return None
        return self.write(batch.slices, num_samples=batch.num_samples,
                          token_count=batch.token_count)


class SessionBase:
    """Default implementations for optional session capabilities."""

    backend: str = "?"

    def save_watermark(self, rank: int, ckpt) -> None:
        raise UnsupportedOperation(
            f"backend {self.backend!r} has no checkpoint-watermark lifecycle")

    def reclaim(self) -> int:
        raise UnsupportedOperation(
            f"backend {self.backend!r} has no reclamation lifecycle")

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.close()
        return False

    def close(self) -> None:
        pass
