"""Family dispatch (port of ``repro.models.model``): one API over every
architecture family — ``dense``, ``moe``, ``vlm``, ``audio``, ``rwkv`` and
``hybrid``.

  param_specs(cfg)                         -> ParamSpec tree
  forward(cfg, params, batch)              -> (logits, aux)
  loss_fn(cfg, params, batch)              -> (loss, {"ce_loss", "aux_loss"})
  decode_state_specs / init_decode_state   -> serving state (KV cache or
                                              recurrent state)
  prefill / decode_step                    -> serving

``batch`` is a dict holding tokens (B, S) int ((B, S, K) for audio's K
codebooks) and, for the transformer families, optional ``frontend_embeds``
(B, P, d_model): precomputed modality embeddings put before the token
embeddings (audio's conditioning prefix). Labels are next-token shifted in
the loss; the prefix positions are left out of it.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.models import mamba2, rwkv6, transformer
from repro_torch.models.common import resolve_device, softmax_cross_entropy
from repro_torch.models.config import ModelConfig

_FAMILIES = {"dense": transformer, "moe": transformer, "vlm": transformer,
             "audio": transformer, "rwkv": rwkv6, "hybrid": mamba2}


def _inputs(cfg: ModelConfig, batch: Dict):
    """(tokens, kwargs of the family's forward / prefill): the transformer
    families take the ``frontend_embeds`` prefix; RWKV and the hybrid have
    none."""
    fe = batch.get("frontend_embeds")
    if fe is None:
        return batch["tokens"], {}
    if _family(cfg) is not transformer:
        raise ValueError(f"family {cfg.family!r} takes no frontend_embeds")
    return batch["tokens"], {"frontend_embeds": fe}


def _family(cfg: ModelConfig):
    """The model module of ``cfg.family``."""
    if cfg.family not in _FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}")
    return _FAMILIES[cfg.family]


def param_specs(cfg: ModelConfig):
    return _family(cfg).param_specs(cfg)


def forward(cfg: ModelConfig, params, batch: Dict
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    tokens, kw = _inputs(cfg, batch)
    return _family(cfg).forward(cfg, params, tokens, **kw)


def loss_fn(cfg: ModelConfig, params, batch: Dict
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token CE of the token positions' logits, ``logits[:, P:][:,
    :-1]`` (P the frontend prefix's length, else 0), against ``tokens[:,
    1:]``, plus the aux loss. Audio's (B, S-1, K, V) logits and (B, S-1, K)
    labels are one mean over all (S-1)·K of a row, as the reference
    reshapes them. Returns (total, {"ce_loss", "aux_loss"})."""
    logits, aux = forward(cfg, params, batch)
    fe = batch.get("frontend_embeds")
    P = fe.shape[1] if fe is not None else 0
    tok_logits, labels = logits[:, P:][:, :-1], batch["tokens"][:, 1:]
    if cfg.family == "audio":
        B, Sm1, K, V = tok_logits.shape
        tok_logits = tok_logits.reshape(B, Sm1 * K, V)
        labels = labels.reshape(B, Sm1 * K)
    loss = softmax_cross_entropy(tok_logits, labels)
    return loss + aux, {"ce_loss": loss, "aux_loss": aux}


def decode_state_specs(cfg: ModelConfig, batch: int, max_seq: int):
    """name -> (shape, dtype) of the decode-time state: the KV cache of
    ``max_seq`` positions, or the recurrent state (independent of it)."""
    return _family(cfg).state_specs(cfg, batch, max_seq)


def init_decode_state(cfg: ModelConfig, batch: int, max_seq: int,
                      device=None):
    """Zeroed decode state on ``device`` (the CUDA card by default): the
    one constructor of a KV cache or recurrent state."""
    dev = resolve_device(device)
    return {k: torch.zeros(shape, dtype=dt, device=dev) for k, (shape, dt)
            in decode_state_specs(cfg, batch, max_seq).items()}


def decode_step(cfg: ModelConfig, params, state, tokens, pos: int):
    return _family(cfg).decode_step(cfg, params, state, tokens, pos)


def prefill(cfg: ModelConfig, params, batch: Dict, cache=None):
    """Last-position logits + the decode state (KV cache or recurrent
    state), written into ``cache`` if given."""
    tokens, kw = _inputs(cfg, batch)
    return _family(cfg).prefill(cfg, params, tokens, cache, **kw)
