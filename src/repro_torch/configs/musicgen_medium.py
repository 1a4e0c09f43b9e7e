"""musicgen-medium — decoder-only over EnCodec tokens [arXiv:2306.05284; hf].

Backbone: 48L d_model=1536 24H (MHA kv=24) d_ff=6144 vocab=2048, 4 EnCodec
codebooks (delay pattern): input embeds are the sum of the 4 codebook
embeddings; output heads predict all 4 codebooks. The EnCodec/text-conditioning
frontend is a STUB: input_specs() provides precomputed conditioning frame
embeddings (B, P, d_model). 24 heads are not divisible by 16-way TP: attention
activations fall back to sequence-parallel sharding.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    num_codebooks=4,
    frontend="audio",
    rope_theta=1e4,
)

SMOKE_CONFIG = CONFIG.replace(
    name="musicgen-medium-smoke",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    head_dim=16,
    d_ff=160,
    vocab_size=65,
    num_codebooks=4,
)
