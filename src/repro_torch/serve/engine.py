"""Batched serving engine (port of ``repro.serve.engine``): prefill +
KV-cache decode over a request batch.

A compact production shape: fixed decode batch, greedy or temperature
sampling, per-slot request lifecycle. On the CUDA card (the default device)
prefill attention, decode attention and every RMSNorm run on the port's
Hopper kernels.

Differences from the JAX engine, the first three for the card's sake:

* the weights JAX casts to ``compute_dtype`` on every use (embed, unembed,
  the attention and FFN matrices) are cast once, at load — the same bits,
  without a fresh copy per call; norm scales stay fp32;
* the (L, B, max_seq, G, dh) KV cache is allocated once per batch and
  written in place by prefill and decode, instead of padded after prefill;
* temperature sampling draws with ``torch.multinomial`` from a seeded
  ``torch.Generator``, which cannot reproduce ``jax.random``: only greedy
  decoding matches the JAX engine token for token;
* the audio family is refused where the JAX engine accepts it and then
  fails on its first decoded token (ROADMAP.md, Queue 3); audio is served
  through ``prefill`` and ``decode_step``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from repro_torch.models import (ModelConfig, decode_step, init_decode_state,
                                prefill)
from repro_torch.models.common import resolve_device
from repro_torch.obs.registry import COUNTER, GAUGE, StatsView

_DENSE_CAST = ("embed", "unembed", "wq", "wk", "wv", "wo", "bq", "bk", "bv",
               "w_gate", "w_up", "w_down")
#: per family, the leaves the JAX model casts to compute_dtype on use (RWKV6
#: keeps w0 and u fp32, as JAX casts them to float32, the MoE router stays
#: fp32, as JAX routes in float32, the hybrid's A_log, dt_bias and D_skip
#: stay fp32, as JAX reads them in float32, audio's codebook tables stay
#: fp32, as JAX sums the K rows in float32 and casts the sum, and so does
#: every norm scale)
_CAST_ON_LOAD = {
    "dense": _DENSE_CAST,
    "moe": _DENSE_CAST + ("sh_gate", "sh_up", "sh_down"),
    "vlm": _DENSE_CAST,
    "audio": tuple(k for k in _DENSE_CAST if k != "embed"),
    "hybrid": _DENSE_CAST + ("in_proj", "conv_w", "conv_b", "out_proj"),
    "rwkv": ("embed", "unembed", "w_r", "w_k", "w_v", "w_g", "w_o", "mix_w1",
             "mix_w2", "mu_base", "mu_rkvgw", "decay_w1", "decay_w2", "cm_k",
             "cm_v", "cm_r", "cm_mu_k", "cm_mu_r"),
}


@dataclass
class Request:
    rid: int
    prompt: np.ndarray          # (P,) int32
    max_new_tokens: int
    generated: List[int] = field(default_factory=list)
    done: bool = False


class EngineStats(StatsView):
    """Registry-backed serving counters (``serve.<instance>.*``)."""

    _FAMILY = "serve"
    _SPEC = {
        "prefills": COUNTER,
        "decode_steps": COUNTER,
        "tokens_out": COUNTER,
        "wall_prefill_s": GAUGE,
        "wall_decode_s": GAUGE,
    }

    @property
    def tokens_per_s(self) -> float:
        return self.tokens_out / max(1e-9, self.wall_decode_s)


def serving_params(cfg: ModelConfig, params, device: torch.device):
    """``params`` on ``device``, with the leaves JAX casts on use already in
    ``cfg.compute_dtype``; every other leaf keeps its dtype."""
    cast = _CAST_ON_LOAD[cfg.family]

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else v.to(
                    device=device,
                    dtype=cfg.cdtype if k in cast else v.dtype)
                for k, v in tree.items()}

    return walk(params)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class ServeEngine:
    """Static-batch engine: requests of equal prompt length are prefilled as
    a batch, then decoded together until every slot finishes."""

    def __init__(self, cfg: ModelConfig, params, max_seq: int,
                 temperature: float = 0.0, seed: int = 0, device=None):
        if cfg.family not in ("dense", "moe", "vlm", "audio"):
            raise ValueError("ServeEngine currently targets KV-cache families; "
                             "use decode_step directly for SSM/hybrid")
        if cfg.family == "audio":
            raise NotImplementedError(
                "ServeEngine does not serve the audio family: the reference "
                "engine's run_batch reads each request's next token as one "
                "int (repro/serve/engine.py, `t = int(tok_np[b])`) and "
                "fails on audio's K codebooks a step (ROADMAP.md, Queue 3); "
                "serve audio through models.prefill and models.decode_step")
        self.device = resolve_device(device)
        self.cfg = cfg
        with torch.inference_mode():
            self.params = serving_params(cfg, params, self.device)
        self.max_seq = max_seq
        self.temperature = temperature
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        self.stats = EngineStats()

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        if self.temperature <= 0:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits.float() / self.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=self._gen)[:, 0]

    @torch.inference_mode()
    def run_batch(self, requests: List[Request],
                  eos_id: Optional[int] = None) -> List[Request]:
        if len({len(r.prompt) for r in requests}) != 1:
            raise ValueError("static batch: equal prompt lengths (pad upstream)")
        B = len(requests)
        P = len(requests[0].prompt)
        if P > self.max_seq:
            raise ValueError(f"prompt length {P} exceeds max_seq {self.max_seq}")
        prompts = torch.from_numpy(
            np.stack([np.asarray(r.prompt, np.int64) for r in requests])
        ).to(self.device)

        t0 = time.monotonic()
        cache = init_decode_state(self.cfg, B, self.max_seq, device=self.device)
        logits, cache = prefill(self.cfg, self.params, {"tokens": prompts},
                                cache=cache)
        _sync(self.device)
        self.stats.prefills += 1
        self.stats.wall_prefill_s += time.monotonic() - t0

        tok = self._sample(logits)
        live = np.ones(B, bool)
        t0 = time.monotonic()
        max_new = max(r.max_new_tokens for r in requests)
        for i in range(max_new):
            tok_np = tok.cpu().numpy()
            for b, r in enumerate(requests):
                if live[b] and len(r.generated) < r.max_new_tokens:
                    t = int(tok_np[b])
                    r.generated.append(t)
                    if (eos_id is not None and t == eos_id) or \
                            len(r.generated) >= r.max_new_tokens:
                        r.done = True
                        live[b] = False
                    self.stats.tokens_out += 1
            if not live.any() or P + i + 1 >= self.max_seq:
                break
            logits, cache = decode_step(self.cfg, self.params, cache, tok,
                                        P + i)
            tok = self._sample(logits)
            self.stats.decode_steps += 1
        _sync(self.device)
        self.stats.wall_decode_s += time.monotonic() - t0
        for r in requests:
            r.done = True
        return requests
