"""Synthetic data sources with configuration-dependent expansion (paper §2.1,
Fig. 1); port of ``repro.data.sources``, copied as it is.

Runtime preprocessing inflates raw inputs by large, content/config-dependent
factors (LeRobot 62-9,068x; OpenCLIP 2.6-41.5x; GR00T 288-5,263x). These sources
model that: each raw record carries a nominal raw size; ``preprocess`` expands
it into training-ready bytes whose volume depends on the *current* pipeline
configuration (resolution, observation history, CRF), with heavy-tailed
per-sample latency heterogeneity.

All sources are deterministic given (seed, index) — required for the replay /
exactly-once tests: re-producing offset k after a crash must yield the same
payload bytes.
"""
from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass, field
from typing import Iterator, Optional, Tuple

import numpy as np


def _rng_for(seed: int, index: int) -> np.random.Generator:
    h = hashlib.blake2b(f"{seed}:{index}".encode(), digest_size=8).digest()
    return np.random.default_rng(int.from_bytes(h, "little"))


@dataclass(frozen=True)
class RawRecord:
    index: int
    raw_bytes: int
    kind: str            # "video" | "image_text" | "text"
    duration_s: float    # content-dependent knob (video length etc.)


@dataclass(frozen=True)
class PreprocessConfig:
    """The *model-dependent* knobs that make expansion unpredictable."""

    resolution: int = 224        # 128..640
    observation_history: int = 1  # 1..4 (GR00T-style)
    fps: float = 2.0
    tokens_per_sample: int = 512
    bytes_per_token: int = 2     # int16 token ids by default

    def expansion_hint(self, kind: str) -> float:
        """Analytic expansion factor used for napkin math in benchmarks.

        Visual tokenization cost follows tile-count plateaus (Fig. 1c): tiles =
        ceil(res/224)^2, so jumps are discrete — reproduced here.
        """
        tiles = math.ceil(self.resolution / 224) ** 2
        if kind == "video":
            return 60.0 * tiles * self.observation_history
        if kind == "image_text":
            return 2.6 * tiles
        return 1.2


class SyntheticSource:
    """Infinite deterministic stream of raw records."""

    def __init__(self, seed: int = 0, kind: str = "video",
                 mean_raw_bytes: int = 65536):
        self.seed = seed
        self.kind = kind
        self.mean_raw_bytes = mean_raw_bytes

    def record(self, index: int) -> RawRecord:
        rng = _rng_for(self.seed, index)
        # log-normal raw sizes: heavy tail like real video corpora
        raw = int(self.mean_raw_bytes * rng.lognormal(mean=0.0, sigma=0.75))
        duration = float(rng.lognormal(mean=1.0, sigma=0.9))  # seconds
        return RawRecord(index=index, raw_bytes=max(1024, raw), kind=self.kind,
                         duration_s=duration)

    def __iter__(self) -> Iterator[RawRecord]:
        i = 0
        while True:
            yield self.record(i)
            i += 1


@dataclass
class PreprocessResult:
    payload: bytes
    tokens: int
    samples: int
    cpu_cost_s: float   # modeled CPU time the transform would take
    expansion: float


def preprocess(record: RawRecord, cfg: PreprocessConfig,
               seed: int = 0) -> PreprocessResult:
    """Deterministically expand a raw record into training-ready bytes.

    Output volume = raw * expansion(config, content); per-sample latency is
    heterogeneous (short vs long clips differ by orders of magnitude, §2.1).
    """
    rng = _rng_for(seed ^ 0x9E3779B9, record.index)
    base_exp = cfg.expansion_hint(record.kind)
    content_factor = 0.5 + record.duration_s / 2.0  # longer clips expand more
    expansion = base_exp * content_factor
    out_bytes = int(record.raw_bytes * expansion)
    out_bytes = max(cfg.tokens_per_sample * cfg.bytes_per_token, out_bytes)
    # deterministic pseudo-payload (cheap to generate, content-addressed)
    block = hashlib.blake2b(f"{seed}:{record.index}:{cfg.resolution}:"
                            f"{cfg.observation_history}".encode(),
                            digest_size=32).digest()
    reps = out_bytes // len(block) + 1
    payload = (block * reps)[:out_bytes]
    tokens = out_bytes // cfg.bytes_per_token
    # modeled CPU cost: decode scales with duration * resolution^2
    cpu = 1e-3 * record.duration_s * (cfg.resolution / 224.0) ** 2 \
        * cfg.observation_history
    return PreprocessResult(payload=payload, tokens=tokens, samples=1,
                            cpu_cost_s=cpu, expansion=expansion)


def expansion_table(kinds=("video", "image_text"),
                    resolutions=(128, 224, 448, 640),
                    histories=(1, 4), seed: int = 0, n: int = 32):
    """Reproduces the paper's Fig. 1 expansion-ratio sweep (benchmark fig1)."""
    source_cache = {k: SyntheticSource(seed=seed, kind=k) for k in kinds}
    rows = []
    for kind in kinds:
        for res in resolutions:
            for hist in histories if kind == "video" else (1,):
                cfg = PreprocessConfig(resolution=res, observation_history=hist)
                exps = []
                for i in range(n):
                    rec = source_cache[kind].record(i)
                    r = preprocess(rec, cfg, seed=seed)
                    exps.append(r.expansion)
                rows.append({
                    "kind": kind, "resolution": res, "history": hist,
                    "expansion_min": min(exps), "expansion_max": max(exps),
                    "expansion_mean": sum(exps) / len(exps),
                })
    return rows
