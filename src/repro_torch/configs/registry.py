"""Architecture registry: --arch <id> -> ModelConfig (full + smoke variants).

Only the configurations the port can run are listed; the others of the JAX
registry are queued in ROADMAP.md.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig

ARCH_IDS: List[str] = ["granite_8b", "rwkv6_3b"]

_ALIASES = {"granite-8b": "granite_8b", "rwkv6-3b": "rwkv6_3b"}


def canonical(arch: str) -> str:
    return _ALIASES.get(arch, arch.replace("-", "_").replace(".", ""))


def _module(arch: str):
    name = canonical(arch)
    if name not in ARCH_IDS:
        raise ValueError(f"architecture {arch!r} is not ported yet "
                         f"(ported: {ARCH_IDS}; see ROADMAP.md)")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE_CONFIG


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
