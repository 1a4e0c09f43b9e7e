"""internvl2-76b — InternViT + InternLM2 VLM [arXiv:2404.16821; unverified].

Backbone: 80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256.
The InternViT frontend is a STUB per the assignment: input_specs() provides
precomputed patch embeddings (B, P, d_model) spliced before token embeddings.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    frontend="vision",
    rope_theta=1e6,
)

SMOKE_CONFIG = CONFIG.replace(
    name="internvl2-76b-smoke",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    head_dim=16,
    d_ff=160,
    vocab_size=257,
)
