"""qwen3-vl-30b-a3b — the PAPER'S OWN end-to-end training target
(BatchWeave §7: HoloAssist video SFT + BEHAVIOR-1K VLA train Qwen3-VL-30B-A3B)
[hf:Qwen/Qwen3-30B-A3B + Qwen3-VL; arXiv:2511.21631].

Backbone: 48L d_model=2048 32H (GQA kv=4, head_dim 128) MoE 128 experts top-8
(per-expert d_ff=768) vocab=151936. The vision tower is a STUB per the
assignment's frontend rule: input_specs() provides precomputed frame/patch
embeddings — which is precisely the payload BatchWeave's TGBs carry in the
paper's experiments (online video decode -> frame embeddings -> token packing).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-vl-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=768,
    vocab_size=151936,
    moe_num_experts=128,
    moe_top_k=8,
    moe_num_shared=0,
    moe_d_ff=768,
    frontend="vision",
    rope_theta=1e6,
)

SMOKE_CONFIG = CONFIG.replace(
    name="qwen3-vl-30b-a3b-smoke",
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
