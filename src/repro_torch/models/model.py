"""Family dispatch (port of ``repro.models.model``): one API over the ported
architecture families — so far only ``dense``.

  param_specs(cfg)                         -> ParamSpec tree
  forward(cfg, params, batch)              -> (logits, aux)
  prefill / decode_step                    -> serving (KV cache from
                                              transformer.init_cache)

``batch`` is a dict holding tokens (B, S) int; a ``frontend_embeds`` entry,
which only the vlm and audio families read, is refused until they are ported.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig

#: where each family that is not ported yet stands in ROADMAP.md, Queue 1
_NOT_PORTED = {
    "moe": "item 3: MoE",
    "rwkv": "item 4: RWKV6",
    "hybrid": "item 5: Mamba2 / Zamba2",
    "vlm": "item 6: frontends",
    "audio": "item 6: frontends",
}


def _tokens(batch: Dict) -> torch.Tensor:
    if "frontend_embeds" in batch:
        raise NotImplementedError(
            "frontend_embeds feed the vlm/audio frontends, which are not "
            f"ported yet (ROADMAP.md, Queue 1 {_NOT_PORTED['vlm']})")
    return batch["tokens"]


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family == "dense":
        return
    if cfg.family in _NOT_PORTED:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet "
            f"(ROADMAP.md, Queue 1 {_NOT_PORTED[cfg.family]})")
    raise ValueError(f"unknown family {cfg.family!r}")


def param_specs(cfg: ModelConfig):
    _check_family(cfg)
    return transformer.param_specs(cfg)


def forward(cfg: ModelConfig, params, batch: Dict
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    _check_family(cfg)
    return transformer.forward(cfg, params, _tokens(batch))


def decode_step(cfg: ModelConfig, params, state, tokens, pos: int):
    _check_family(cfg)
    return transformer.decode_step(cfg, params, state, tokens, pos)


def prefill(cfg: ModelConfig, params, batch: Dict, cache=None):
    """Last-position logits + the KV cache (written into ``cache`` if given)."""
    _check_family(cfg)
    return transformer.prefill(cfg, params, _tokens(batch), cache=cache)
