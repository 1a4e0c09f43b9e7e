"""Online token packing into Global Batches (paper §2.1 'batch membership').

Batch boundaries are known only after preprocessing completes: the packer
accumulates variable-size preprocessed sample outputs and emits a TGB's worth of
slice payloads once ``global_batch x seq_len`` tokens are available. Slice
``(d, c)`` carries tokens for DP replica ``d`` (batch-dim split) and CP rank
``c`` (sequence-dim split), stored as little-endian int32.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclass
class PackedBatch:
    """One Global Batch worth of token data, pre-split into (d, c) slices.

    ``num_samples`` counts the samples *completed* in this batch (a sample is
    attributed to the batch holding its final token), so sample counts sum
    exactly to the samples fed across any emit/flush sequence. ``token_count``
    is the number of real (pre-padding) tokens.
    """

    slices: Dict[Tuple[int, int], bytes]
    num_samples: int
    token_count: int


class GlobalBatchPacker:
    """Accumulate token streams; emit complete (D x C)-sliced global batches.

    Sequences longer than ``seq_len`` are chunked; shorter remainders are packed
    contiguously (document packing) so no padding is wasted. Membership of each
    batch is decided *by the packer output order* — a runtime artifact, exactly
    the property BatchWeave's manifest publishes atomically.
    """

    def __init__(self, global_batch: int, seq_len: int, dp: int, cp: int,
                 dtype=np.int32):
        if global_batch % dp:
            raise ValueError(f"global_batch {global_batch} % dp {dp} != 0")
        if seq_len % cp:
            raise ValueError(f"seq_len {seq_len} % cp {cp} != 0")
        self.global_batch = global_batch
        self.seq_len = seq_len
        self.dp = dp
        self.cp = cp
        self.dtype = np.dtype(dtype)
        self._buf: List[np.ndarray] = []
        self._buf_samples: List[int] = []  # sample count per buffered chunk
        self._buffered_tokens = 0

    @property
    def tokens_per_batch(self) -> int:
        return self.global_batch * self.seq_len

    @property
    def buffered_tokens(self) -> int:
        """Tokens currently held back waiting for a full batch."""
        return self._buffered_tokens

    @property
    def buffered_samples(self) -> int:
        """Samples whose final token has not yet been emitted."""
        return sum(self._buf_samples)

    def add_tokens(self, tokens: np.ndarray, samples: int = 1) -> List[PackedBatch]:
        """Feed preprocessed tokens; returns zero or more completed batches."""
        tokens = np.asarray(tokens, dtype=self.dtype).ravel()
        self._buf.append(tokens)
        self._buf_samples.append(samples)
        self._buffered_tokens += tokens.size
        out = []
        while self._buffered_tokens >= self.tokens_per_batch:
            out.append(self._emit())
        return out

    def flush(self, pad_token: int = 0) -> Optional[PackedBatch]:
        """Emit the final partial batch at end-of-stream, padded to a full
        grid with ``pad_token``.

        Without this, remainder tokens smaller than ``tokens_per_batch`` are
        silently stranded in the buffer when the source stream ends. The
        emitted batch's ``token_count`` is the number of *real* (pre-padding)
        tokens, so accounting stays honest. Returns ``None`` when the buffer
        is empty (nothing stranded).
        """
        if self._buffered_tokens == 0:
            return None
        real = self._buffered_tokens
        pad = self.tokens_per_batch - real
        # the pad chunk completes no sample: it must not perturb accounting
        self._buf.append(np.full(pad, pad_token, dtype=self.dtype))
        self._buf_samples.append(0)
        self._buffered_tokens += pad
        return self._emit(real_tokens=real)

    def _emit(self, real_tokens: Optional[int] = None) -> PackedBatch:
        need = self.tokens_per_batch
        chunks, got, samples = [], 0, 0
        while got < need:
            head = self._buf[0]
            take = min(head.size, need - got)
            chunks.append(head[:take])
            if take == head.size:
                # chunk fully consumed: its samples end inside this batch
                self._buf.pop(0)
                samples += self._buf_samples.pop(0)
            else:
                # split chunk: its samples stay with the remainder, so the
                # batch that eventually holds their final tokens (possibly a
                # padded flush) carries them — a partial flush used to report
                # num_samples=0 while carrying real tokens
                self._buf[0] = head[take:]
            got += take
        flat = np.concatenate(chunks)
        self._buffered_tokens -= need
        grid = flat.reshape(self.global_batch, self.seq_len)
        slices: Dict[Tuple[int, int], bytes] = {}
        bs = self.global_batch // self.dp
        cs = self.seq_len // self.cp
        for d in range(self.dp):
            for c in range(self.cp):
                block = grid[d * bs:(d + 1) * bs, c * cs:(c + 1) * cs]
                slices[(d, c)] = np.ascontiguousarray(block).tobytes()
        return PackedBatch(slices=slices, num_samples=samples,
                           token_count=need if real_tokens is None
                           else real_tokens)


def decode_slice(payload: bytes, batch_per_dp: int, seq_per_cp: int,
                 dtype=np.int32) -> np.ndarray:
    """Inverse of the packer's slice serialization (consumer side)."""
    arr = np.frombuffer(payload, dtype=dtype)
    return arr.reshape(batch_per_dp, seq_per_cp)


def assemble_grid(slices: Dict[Tuple[int, int], bytes], global_batch: int,
                  seq_len: int, dp: int, cp: int, dtype=np.int32) -> np.ndarray:
    """Inverse of the packer's (D x C) split: the full token grid.

    Trainer-side fan-in — given every ``(d, c)`` slice of one global batch
    (a ``PackedBatch.slices`` dict, or payloads gathered from per-rank
    readers), rebuild the ``(global_batch, seq_len)`` grid the packer
    sliced. Raises ``KeyError`` on a missing mesh position.
    """
    bs = global_batch // dp
    cs = seq_len // cp
    rows = [[decode_slice(slices[(d, c)], bs, cs, dtype) for c in range(cp)]
            for d in range(dp)]
    return np.block(rows)
