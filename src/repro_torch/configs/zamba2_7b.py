"""zamba2-7b — Mamba2 + shared attention blocks [arXiv:2411.15242; unverified].

81L (Mamba2) d_model=3584 32H (GQA kv=32) d_ff=14336 vocab=32000 ssm_state=64.
One shared transformer block invoked after every 6 Mamba2 layers
(81 = 13 x 6 + 3); per-invocation LoRA adapters omitted (DESIGN.md §4).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    attn_every=6,
    rope_theta=1e4,
)

SMOKE_CONFIG = CONFIG.replace(
    name="zamba2-7b-smoke",
    num_layers=9,
    attn_every=4,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=160,
    vocab_size=257,
    ssm_state=8,
    ssm_head_dim=16,
    ssm_chunk=8,
)
