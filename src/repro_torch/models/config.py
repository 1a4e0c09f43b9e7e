"""Unified model configuration (port of ``repro.models.config``).

The fields match the JAX ``ModelConfig`` one for one, so ``dataclasses.asdict``
of a config is the same in both packages. Fields that only steer JAX/TPU
execution (``scan_layers``, ``decode_cache_mode``) are kept for that parity
and have no effect here: the port runs eagerly, loops over layers and
updates the KV cache in place. ``remat`` does act: a training forward
recomputes each layer in the backward.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | rwkv | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    qkv_bias: bool = False
    rope_theta: float = 1e4
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # -- MoE ----------------------------------------------------------------
    moe_num_experts: int = 0
    moe_top_k: int = 0
    moe_num_shared: int = 0
    moe_d_ff: int = 0
    moe_capacity_factor: float = 1.25
    moe_aux_coef: float = 0.01
    moe_dispatch: str = "local"

    # -- SSM / RWKV / hybrid ----------------------------------------------------
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    attn_every: int = 0
    rwkv_head_dim: int = 64
    rwkv_lora_rank: int = 64

    # -- modality frontends ---------------------------------------------------
    frontend: str = "none"
    num_codebooks: int = 1

    # -- numerics / execution ---------------------------------------------------
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: bool = True                # with grad enabled, each layer runs
    #                                   under torch.utils.checkpoint (JAX:
    #                                   jax.checkpoint, nothing_saveable)
    scan_layers: bool = True          # JAX only; kept for asdict parity
    attention_impl: str = "auto"      # JAX only; kept for asdict parity (the
    #                                   port runs K1 on CUDA, dense on the CPU)
    attention_chunk: int = 1024       # JAX only; kept for asdict parity
    decode_cache_mode: str = "readonly_fused"   # JAX only; both modes compute
    #                                   the same function as the port's
    #                                   in-place cache write
    rwkv_chunk: int = 64
    ssm_chunk: int = 64
    logits_softcap: float = 0.0

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(1, self.num_heads))

    @property
    def pdtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def cdtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    @property
    def attention_free(self) -> bool:
        return self.family == "rwkv"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k (SSM / hybrid / linear-attention)."""
        return self.family in ("rwkv", "hybrid")

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # -- parameter counting ------------------------------------------------------
    def param_count(self) -> int:
        from repro_torch.models.common import tree_leaves
        from repro_torch.models.model import param_specs
        return int(sum(np.prod(s.shape) for s in tree_leaves(param_specs(self))))

    def active_param_count(self) -> int:
        """Params touched per token (MoE: routed top-k + shared only)."""
        total = self.param_count()
        if self.family != "moe" or not self.moe_num_experts:
            return total
        per_expert = 3 * self.d_model * self.moe_d_ff
        inactive = self.moe_num_experts - self.moe_top_k
        return int(total - self.num_layers * inactive * per_expert)
