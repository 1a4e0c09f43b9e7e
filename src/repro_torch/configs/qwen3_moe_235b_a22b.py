"""qwen3-moe-235b-a22b — 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B family; hf].

94L d_model=4096 64H (GQA kv=4) per-expert d_ff=1536 vocab=151936.
head_dim=128 per the Qwen3 family (explicit head_dim, H*dh != d_model).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    head_dim=128,
    d_ff=1536,
    vocab_size=151936,
    moe_num_experts=128,
    moe_top_k=8,
    moe_num_shared=0,
    moe_d_ff=1536,
    rope_theta=1e6,
)

SMOKE_CONFIG = CONFIG.replace(
    name="qwen3-moe-235b-a22b-smoke",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=32,
    vocab_size=257,
    moe_num_experts=8,
    moe_top_k=2,
    moe_d_ff=32,
)
