"""The work the benchmark credits: a training step's model FLOPs and each
kernel operator's FLOPs and bytes, from shapes alone.

Model FLOPs of a step are 6 x the matmul parameters a position uses x the
positions, plus the causal attention products (QK^T and PV over the pairs
j <= i, forward and backward = 3 x forward). The token embedding is a
lookup and counts nothing; an MoE layer counts its router and its top-k
experts; recomputation (remat, the backward rules' recompute) is not
counted.
"""
from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).with_name("peaks.json")).read_text())


def matmul_params(m: dict) -> int:
    """Weights a position multiplies by, in one forward."""
    D, H, G, dh = m["d_model"], m["num_heads"], m["num_kv_heads"], m["head_dim"]
    attn = D * H * dh + 2 * D * G * dh + H * dh * D
    if m.get("moe_num_experts"):
        ffn = m["moe_top_k"] * 3 * D * m["moe_d_ff"] + D * m["moe_num_experts"]
    else:
        ffn = 3 * D * m["d_ff"]
    return m["num_layers"] * (attn + ffn) + D * m["vocab_size"]


def causal_attention_flops(B: int, H: int, S: int, dh: int) -> int:
    """QK^T and PV of one causal self-attention forward: 2 products of
    2 * dh FLOPs over each of the S (S + 1) / 2 pairs, every head."""
    return 4 * B * H * dh * (S * (S + 1) // 2)


def step_model_flops(m: dict, global_batch: int, seq_len: int, prefix: int = 0) -> int:
    """Model FLOPs of one training step over (global_batch, prefix + seq_len)
    positions."""
    S = prefix + seq_len
    dense = 6 * matmul_params(m) * global_batch * S
    attn = 3 * m["num_layers"] * causal_attention_flops(global_batch, m["num_heads"], S,
                                                         m["head_dim"])
    return dense + attn


def attention_op_work(q_shape, k_shape, causal: bool = True):
    """(FLOPs, bytes) of one attention forward call: q (B, S, H, dh) and
    k, v (B, T, G, dh) read once and o written once, bf16. Causal calls
    with S == T count the pairs j <= i; otherwise every pair."""
    B, S, H, dh = q_shape
    T, G = k_shape[1], k_shape[2]
    pairs = S * (S + 1) // 2 if causal and S == T else S * T
    flops = 4 * B * H * dh * pairs
    nbytes = 2 * (2 * B * S * H * dh + 2 * B * T * G * dh)
    return flops, nbytes


def rmsnorm_op_work(x_shape, scale_shape):
    """(FLOPs, bytes) of one RMSNorm forward: x (bf16) read once, the output
    (bf16) written once, the fp32 scale read once; 4 FLOPs an element."""
    n = 1
    for s in x_shape:
        n *= s
    return 4 * n, 2 * n + 2 * n + 4 * scale_shape[-1]


def least_seconds(flops: float, nbytes: float, peaks: dict = None) -> float:
    """The roofline's least time: the larger of FLOPs over the bf16 peak
    and bytes over the memory peak."""
    peaks = peaks or PEAKS
    return max(flops / peaks["bf16_flops_per_s"], nbytes / peaks["hbm_bytes_per_s"])
