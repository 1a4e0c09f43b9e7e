"""deepseek-moe-16b — fine-grained MoE: 2 shared + 64 routed top-6
[arXiv:2401.06066; hf].

28L d_model=2048 16H (GQA kv=16) per-expert d_ff=1408 vocab=102400.
(The HF model's dense first layer is simplified to MoE-everywhere; noted in
DESIGN.md §4.)
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,             # kept for reference; MoE path uses moe_d_ff
    vocab_size=102400,
    moe_num_experts=64,
    moe_top_k=6,
    moe_num_shared=2,
    moe_d_ff=1408,
    rope_theta=1e4,
)

SMOKE_CONFIG = CONFIG.replace(
    name="deepseek-moe-16b-smoke",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=32,
    vocab_size=257,
    moe_num_experts=8,
    moe_top_k=2,
    moe_num_shared=1,
    moe_d_ff=32,
)
