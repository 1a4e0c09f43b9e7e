"""Twin of ``tests/test_packing_properties.py`` on the port: property tests of
``repro_torch.data.packing.GlobalBatchPacker`` (hypothesis, or the
deterministic fallback shim from conftest where hypothesis is absent), with
the reference's settings: token conservation, pad and sample accounting
(the partial-flush regression), and the ``decode_slice`` /
``assemble_grid`` round trip. Imports neither jax nor msgpack.
"""
from __future__ import annotations

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

pytest.importorskip("torch")

from repro_torch.data.packing import (GlobalBatchPacker,  # noqa: E402
                                      assemble_grid, decode_slice)


def _drain(packer, chunks, pad_token=0):
    """Feed (tokens, samples) chunks; return (batches, flush_batch)."""
    out = []
    for toks, samples in chunks:
        out.extend(packer.add_tokens(toks, samples=samples))
    return out, packer.flush(pad_token=pad_token)


def _grids(packer, batches):
    return [assemble_grid(b.slices, packer.global_batch, packer.seq_len,
                          packer.dp, packer.cp) for b in batches]


@settings(max_examples=40, deadline=None)
@given(dp=st.sampled_from([1, 2, 4]),
       cp=st.sampled_from([1, 2]),
       gb_mult=st.integers(min_value=1, max_value=3),
       seq_mult=st.integers(min_value=1, max_value=5),
       sizes=st.lists(st.integers(min_value=1, max_value=97),
                      min_size=1, max_size=20),
       pad_token=st.sampled_from([0, 7, -1]))
def test_token_conservation_and_pad_accounting(dp, cp, gb_mult, seq_mult,
                                               sizes, pad_token):
    gb, seq = dp * gb_mult, cp * seq_mult
    packer = GlobalBatchPacker(gb, seq, dp=dp, cp=cp)
    chunks = []
    base = 0
    for n in sizes:
        chunks.append((np.arange(base, base + n, dtype=np.int32),
                       1 + n % 3))
        base += n
    total_real = base
    total_samples = sum(s for _, s in chunks)

    batches, tail = _drain(packer, chunks, pad_token=pad_token)
    emitted = batches + ([tail] if tail is not None else [])

    # every emitted grid is full-size; the concatenation replays the stream
    flat = np.concatenate([g.ravel() for g in _grids(packer, emitted)]) \
        if emitted else np.empty(0, np.int32)
    assert flat.size == len(emitted) * gb * seq
    np.testing.assert_array_equal(flat[:total_real],
                                  np.arange(total_real, dtype=np.int32))
    # pad accounting: token_count sums to the real tokens; padding is pad_token
    assert sum(b.token_count for b in emitted) == total_real
    np.testing.assert_array_equal(
        flat[total_real:],
        np.full(flat.size - total_real, pad_token, dtype=np.int32))
    # sample conservation across emit + flush
    assert sum(b.num_samples for b in emitted) == total_samples
    # nothing stranded
    assert packer.buffered_tokens == 0
    assert packer.buffered_samples == 0


@settings(max_examples=30, deadline=None)
@given(dp=st.sampled_from([1, 2, 3, 4]),
       cp=st.sampled_from([1, 2, 4]),
       bs=st.integers(min_value=1, max_value=4),
       cs=st.integers(min_value=1, max_value=8))
def test_decode_slice_round_trip(dp, cp, bs, cs):
    gb, seq = dp * bs, cp * cs
    grid = np.arange(gb * seq, dtype=np.int32).reshape(gb, seq)
    packer = GlobalBatchPacker(gb, seq, dp=dp, cp=cp)
    (batch,) = packer.add_tokens(grid.ravel())
    # each (d, c) slice decodes to its block of the source grid
    for d in range(dp):
        for c in range(cp):
            block = decode_slice(batch.slices[(d, c)], bs, cs)
            np.testing.assert_array_equal(
                block, grid[d * bs:(d + 1) * bs, c * cs:(c + 1) * cs])
    # and the full inverse reassembles the grid bit-for-bit
    np.testing.assert_array_equal(
        assemble_grid(batch.slices, gb, seq, dp, cp), grid)


def test_flush_partial_batch_sample_accounting_regression():
    """A 3-sample chunk whose tail lands in the padded flush: the flush
    batch must carry those samples (it used to report num_samples=0 while
    carrying 4 real tokens, because _emit attributed every buffered sample
    to the first emitted batch)."""
    packer = GlobalBatchPacker(2, 4, dp=1, cp=1)   # 8 tokens per batch
    (full,) = packer.add_tokens(np.arange(12), samples=3)
    assert full.token_count == 8
    # the chunk's final token is still buffered: no sample completed yet
    assert full.num_samples == 0
    assert packer.buffered_samples == 3
    tail = packer.flush(pad_token=0)
    assert tail is not None
    assert tail.token_count == 4            # 4 real + 4 pad
    assert tail.num_samples == 3            # the regression: this was 0
    assert full.num_samples + tail.num_samples == 3


def test_sample_attribution_follows_last_token():
    """Samples count in the batch holding their final token."""
    packer = GlobalBatchPacker(1, 8, dp=1, cp=1)   # 8 tokens per batch
    # chunk A (5 tokens, 1 sample) ends inside batch 0; chunk B (5 tokens,
    # 1 sample) straddles the boundary and ends in the flush batch
    assert packer.add_tokens(np.arange(5), samples=1) == []
    (b0,) = packer.add_tokens(np.arange(5), samples=1)
    assert b0.num_samples == 1
    tail = packer.flush()
    assert tail.num_samples == 1
    assert tail.token_count == 2
