"""Architecture registry: --arch <id> -> ModelConfig (full + smoke variants).

The JAX registry's configurations, in its order.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig

ARCH_IDS: List[str] = [
    "rwkv6_3b", "qwen15_32b", "llama3_405b", "granite_8b", "deepseek_67b",
    "deepseek_moe_16b", "qwen3_moe_235b_a22b", "zamba2_7b", "internvl2_76b",
    "musicgen_medium",
    # the paper's own end-to-end training target
    "qwen3_vl_30b_a3b",
]

_ALIASES = {
    "rwkv6-3b": "rwkv6_3b",
    "qwen1.5-32b": "qwen15_32b",
    "llama3-405b": "llama3_405b",
    "granite-8b": "granite_8b",
    "deepseek-67b": "deepseek_67b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "zamba2-7b": "zamba2_7b",
    "internvl2-76b": "internvl2_76b",
    "musicgen-medium": "musicgen_medium",
    "qwen3-vl-30b-a3b": "qwen3_vl_30b_a3b",
}


def canonical(arch: str) -> str:
    return _ALIASES.get(arch, arch.replace("-", "_").replace(".", ""))


def _module(arch: str):
    name = canonical(arch)
    if name not in ARCH_IDS:
        raise ValueError(f"unknown architecture {arch!r} (known: {ARCH_IDS})")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE_CONFIG


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}
