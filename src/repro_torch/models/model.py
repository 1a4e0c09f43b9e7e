"""Family dispatch (port of ``repro.models.model``): one API over the ported
architecture families — so far ``dense`` and ``rwkv``.

  param_specs(cfg)                         -> ParamSpec tree
  forward(cfg, params, batch)              -> (logits, aux)
  loss_fn(cfg, params, batch)              -> (loss, {"ce_loss", "aux_loss"})
  decode_state_specs / init_decode_state   -> serving state (KV cache or
                                              recurrent state)
  prefill / decode_step                    -> serving

``batch`` is a dict holding tokens (B, S) int; a ``frontend_embeds`` entry,
which only the vlm and audio families read, is refused until they are ported.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.models import rwkv6, transformer
from repro_torch.models.common import resolve_device, softmax_cross_entropy
from repro_torch.models.config import ModelConfig

#: where each family that is not ported yet stands in ROADMAP.md, Queue 1
_NOT_PORTED = {
    "moe": "item 3: MoE",
    "hybrid": "item 5: Mamba2 / Zamba2",
    "vlm": "item 6: frontends",
    "audio": "item 6: frontends",
}
_PORTED = {"dense": transformer, "rwkv": rwkv6}


def _tokens(batch: Dict) -> torch.Tensor:
    if "frontend_embeds" in batch:
        raise NotImplementedError(
            "frontend_embeds feed the vlm/audio frontends, which are not "
            f"ported yet (ROADMAP.md, Queue 1 {_NOT_PORTED['vlm']})")
    return batch["tokens"]


def _family(cfg: ModelConfig):
    """The model module of ``cfg.family``."""
    if cfg.family in _PORTED:
        return _PORTED[cfg.family]
    if cfg.family in _NOT_PORTED:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet "
            f"(ROADMAP.md, Queue 1 {_NOT_PORTED[cfg.family]})")
    raise ValueError(f"unknown family {cfg.family!r}")


def param_specs(cfg: ModelConfig):
    return _family(cfg).param_specs(cfg)


def forward(cfg: ModelConfig, params, batch: Dict
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    return _family(cfg).forward(cfg, params, _tokens(batch))


def loss_fn(cfg: ModelConfig, params, batch: Dict
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token CE of ``logits[:, :-1]`` against ``tokens[:, 1:]``, plus
    the aux loss. Returns (total, {"ce_loss", "aux_loss"})."""
    logits, aux = forward(cfg, params, batch)
    loss = softmax_cross_entropy(logits[:, :-1], batch["tokens"][:, 1:])
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
    return _family(cfg).prefill(cfg, params, _tokens(batch), cache)
