"""The work the benchmark credits that no model family owns: each kernel
operator's FLOPs and bytes from its shapes, the causal attention products,
the roofline's least time, and the chip's peaks.

A step's model FLOPs are the family's: ``step_model_flops(m, global_batch,
seq_len, prefix)`` of the reference module the configuration names
(``wb/reference/<reference>.py``), which the harness calls for
``step.mfu``. The kernel readers (``metrics/*_roofline.py``) take the calls
of their operator from the traced slice, which records every
``repro_torch::`` operator, and the work of each call from here.
"""
from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).with_name("peaks.json")).read_text())


def causal_attention_flops(B: int, H: int, S: int, dh: int) -> int:
    """QK^T and PV of one causal self-attention forward: 2 products of
    2 * dh FLOPs over each of the S (S + 1) / 2 pairs, every head."""
    return 4 * B * H * dh * (S * (S + 1) // 2)


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
