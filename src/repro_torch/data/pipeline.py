"""Disaggregated preprocessing pipeline: source -> preprocess -> pack -> TGB
(port of ``repro.data.pipeline``).

This is the producer-side glue (paper Fig. 4 stage 1): a preprocessing worker
pulls raw records, runs the runtime-dependent transform, packs tokens into
global batches, and hands complete (D x C)-sliced payloads to the BatchWeave
``Producer``. Deterministic given (seed, stream offset) so crash/replay yields
identical TGBs.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from repro_torch.core.producer import Producer
from repro_torch.data.packing import GlobalBatchPacker, PackedBatch
from repro_torch.data.sources import (PreprocessConfig, PreprocessResult,
                                      SyntheticSource, preprocess)


@dataclass
class PipelineConfig:
    global_batch: int
    seq_len: int
    dp: int
    cp: int
    vocab_size: int = 32000
    seed: int = 0
    simulate_cpu_cost: bool = False  # sleep preprocess cpu_cost_s on the clock


class PreprocessWorker:
    """One producer node's preprocessing loop."""

    def __init__(self, pipe_cfg: PipelineConfig, prep_cfg: PreprocessConfig,
                 producer: Producer, source: Optional[SyntheticSource] = None,
                 sample_stride: int = 1, sample_offset: int = 0):
        self.cfg = pipe_cfg
        self.prep = prep_cfg
        self.producer = producer
        self.source = source or SyntheticSource(seed=pipe_cfg.seed)
        self.packer = GlobalBatchPacker(pipe_cfg.global_batch, pipe_cfg.seq_len,
                                        pipe_cfg.dp, pipe_cfg.cp)
        self.sample_stride = sample_stride  # shard the source across workers
        self.sample_offset = sample_offset
        self._next_sample = sample_offset

    def _tokens_from(self, result: PreprocessResult, index: int) -> np.ndarray:
        """Turn preprocessed bytes into a learnable token stream: a noisy
        successor sequence (t[i+1] = t[i] + 1 mod V with p=0.9) so the e2e
        example's loss demonstrably falls."""
        rng = np.random.default_rng(self.cfg.seed * 1_000_003 + index)
        n = max(16, result.tokens // 64)  # keep example-scale token counts sane
        start = rng.integers(0, self.cfg.vocab_size)
        seq = (start + np.arange(n)) % self.cfg.vocab_size
        noise = rng.random(n) < 0.1
        seq = np.where(noise, rng.integers(0, self.cfg.vocab_size, n), seq)
        return seq.astype(np.int32)

    def produce_n_tgbs(self, n: int,
                       stop: Optional[threading.Event] = None) -> int:
        """Run until ``n`` TGBs are written+queued for commit. Returns count."""
        made = 0
        clock = self.producer.clock
        while made < n:
            if stop is not None and stop.is_set():
                break
            rec = self.source.record(self._next_sample)
            self._next_sample += self.sample_stride
            result = preprocess(rec, self.prep, seed=self.cfg.seed)
            if self.cfg.simulate_cpu_cost:
                clock.sleep(result.cpu_cost_s)
            for batch in self.packer.add_tokens(
                    self._tokens_from(result, rec.index)):
                self.producer.write_tgb(
                    slice_payloads=batch.slices,
                    num_samples=batch.num_samples,
                    token_count=batch.token_count)
                made += 1
                self.producer.maybe_commit()
                if made >= n:
                    break
        return made
