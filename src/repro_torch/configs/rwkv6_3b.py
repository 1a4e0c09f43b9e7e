"""rwkv6-3b — Finch: attention-free, data-dependent decay [arXiv:2404.05892; hf].

32L d_model=2560 d_ff=8960 vocab=65536; head_dim 64 -> 40 WKV heads.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="rwkv",
    num_layers=32,
    d_model=2560,
    num_heads=40,          # d_model / rwkv_head_dim
    num_kv_heads=40,
    d_ff=8960,
    vocab_size=65536,
    rwkv_head_dim=64,
    rwkv_lora_rank=64,
)

SMOKE_CONFIG = CONFIG.replace(
    name="rwkv6-3b-smoke",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=160,
    vocab_size=257,
    rwkv_head_dim=16,
    rwkv_lora_rank=8,
    rwkv_chunk=8,
)
