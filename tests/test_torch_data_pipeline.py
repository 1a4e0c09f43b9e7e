"""Twin of ``tests/test_data_pipeline.py:18-50`` on the port: the packer
conserves the token stream (hypothesis, with the reference's settings) and
preprocessing replays deterministically, against ``repro_torch.data``. The
twin of ``:52`` is ``tests/test_torch_data_pipeline_expansion.py`` (a file
of its own: it is the slow one), and those of ``:62-113`` are in
``tests/test_torch_baselines.py``. Imports neither jax nor msgpack.
"""
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

pytest.importorskip("torch")

from repro_torch.data import (GlobalBatchPacker, PreprocessConfig,  # noqa: E402
                              SyntheticSource, decode_slice, preprocess)


@settings(max_examples=30, deadline=None)
@given(gb=st.sampled_from([2, 4, 8]), seq=st.sampled_from([8, 16]),
       dp=st.sampled_from([1, 2, 4]), cp=st.sampled_from([1, 2]),
       chunks=st.lists(st.integers(1, 200), min_size=1, max_size=30))
def test_packer_conserves_token_stream(gb, seq, dp, cp, chunks):
    """Property: concatenating emitted batches reproduces the input stream."""
    if gb % dp or seq % cp:
        return
    packer = GlobalBatchPacker(gb, seq, dp, cp)
    stream = []
    out_batches = []
    next_tok = 0
    for n in chunks:
        toks = np.arange(next_tok, next_tok + n, dtype=np.int32)
        next_tok += n
        stream.append(toks)
        out_batches.extend(packer.add_tokens(toks))
    stream_flat = np.concatenate(stream)
    consumed = 0
    for b in out_batches:
        grid = np.zeros((gb, seq), np.int32)
        bs, cs = gb // dp, seq // cp
        for (d, c), payload in b.slices.items():
            grid[d * bs:(d + 1) * bs, c * cs:(c + 1) * cs] = \
                decode_slice(payload, bs, cs)
        np.testing.assert_array_equal(
            grid.ravel(), stream_flat[consumed:consumed + gb * seq])
        consumed += gb * seq


def test_preprocess_deterministic_replay():
    src = SyntheticSource(seed=3)
    cfg = PreprocessConfig(resolution=448, observation_history=2)
    a = preprocess(src.record(17), cfg, seed=3)
    b = preprocess(src.record(17), cfg, seed=3)
    assert a.payload == b.payload and a.tokens == b.tokens
