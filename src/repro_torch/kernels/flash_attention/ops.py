"""Flash attention as an autograd Function: CUDA tensor ->
``csrc/flash_attention.cu``; CPU tensor -> plain.

The backward is the reference's own rule
(``src/repro/kernels/flash_attention/ops.py`` ``_bwd``): recompute the plain
version and differentiate it.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels.common import (aligned16, launch, load, on_cpu,
                                        require)
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {"flash_attention_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                     ctypes.c_float, _I, _P]}
HEAD_DIMS = (64, 128)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """The forward alone: K1 on CUDA tensors, ``flash_attention_ref`` on CPU
    ones."""
    if on_cpu(q, k, v):
        return flash_attention_ref(q, k, v, causal)
    B, S, H, dh = q.shape
    T, G = k.shape[1], k.shape[2]
    require(q.dtype == k.dtype == v.dtype == torch.bfloat16,
            f"flash_attention kernel takes bfloat16, got "
            f"{q.dtype}/{k.dtype}/{v.dtype}")
    require(tuple(k.shape) == tuple(v.shape) == (B, T, G, dh) and H % G == 0,
            f"flash_attention shapes: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)}")
    require(dh in HEAD_DIMS, f"flash_attention kernel takes head_dim in "
                             f"{HEAD_DIMS}, got {dh}")
    require(q.is_contiguous() and k.is_contiguous() and v.is_contiguous()
            and aligned16(q, k, v),
            "flash_attention kernel takes contiguous 16-byte aligned tensors")
    require(T > 0, "flash_attention needs at least one key")
    out = torch.empty_like(q)
    lib = load("flash_attention", _ARGTYPES)
    launch("flash_attention", lib.flash_attention_fwd, q.device,
           q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
           B, S, T, H, G, dh, 1.0 / math.sqrt(dh), int(causal))
    return out


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool, g: torch.Tensor):
    """(dq, dk, dv) in the inputs' dtype: the vjp of ``flash_attention_ref``
    against the cotangent ``g``. dk and dv sum over each KV head's query
    heads."""
    with torch.enable_grad():
        q_, k_, v_ = (t.detach().requires_grad_() for t in (q, k, v))
        return torch.autograd.grad(flash_attention_ref(q_, k_, v_, causal),
                                   (q_, k_, v_), g)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal):
        ctx.save_for_backward(q, k, v)
        ctx.causal = causal
        return flash_attention_fwd(q, k, v, causal)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        return (*flash_attention_bwd(q, k, v, ctx.causal, g), None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q: (B, S, H, dh); k/v: (B, T, G, dh), H % G == 0 -> (B, S, H, dh).

    Query row i sees keys j <= i when ``causal``. Ragged S and T are masked
    inside the kernel (no divisibility requirement). Differentiable in q, k
    and v.
    """
    return _FlashAttention.apply(q, k, v, causal)
