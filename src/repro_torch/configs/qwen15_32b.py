"""qwen1.5-32b — dense, QKV bias [hf:Qwen/Qwen1.5-0.5B family; hf].

64L d_model=5120 40H (GQA kv=40, i.e. MHA) d_ff=27392 vocab=152064.
40 heads are not divisible by the 16-way TP axis: the sharding rules fall back
to sequence-parallel attention activations (DESIGN.md §5).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=40,
    d_ff=27392,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1e6,
)

SMOKE_CONFIG = CONFIG.replace(
    name="qwen1.5-32b-smoke",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=160,
    vocab_size=257,
)
