"""Multi-stream data plane: named TGB streams with deterministic weighted
mixing.

Modern LFM training draws from many corpora with per-source weights (web,
code, domain SFT, ...). This package composes BatchWeave's single-stream TGB
semantics across sources:

  ``MixPlan``            deterministic weighted interleave — a pure function
                         of (weights, seed, step); no schedule is stored.
  ``Stream``             one named stream = an independent manifest chain
                         under ``<run>/streams/<name>/...``.
  ``MixedReader``        the facade ``BatchReader`` multiplexing per-stream
                         consumers; composite exactly-once checkpoints.
  ``MultiStreamSession`` the session facade: per-stream writers, mixed
                         readers, mix-aware per-stream lifecycle.

Entry point: ``open_dataplane(store, topo, backend="tgb",
streams={"web": 0.7, "code": 0.3}, mix_seed=...)``.

Port of ``repro.streams``, copied as it is but for its imports.
"""
from repro_torch.streams.mixed_reader import MixedReader
from repro_torch.streams.mixplan import MixPlan
from repro_torch.streams.session import MultiStreamSession
from repro_torch.streams.stream import Stream

__all__ = ["MixPlan", "MixedReader", "MultiStreamSession", "Stream"]
