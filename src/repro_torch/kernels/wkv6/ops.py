"""WKV6 as an autograd Function: CUDA tensor -> ``csrc/wkv6.cu``; CPU tensor
-> plain.

From a zero state, as the Pallas kernel. The backward differentiates
``wkv6_chunked`` at the caller's chunk, the function the JAX model
differentiates (``src/repro/models/rwkv6.py``); the reference's ``_bwd``
(``src/repro/kernels/wkv6/ops.py``) takes the vjp of the per-step
``wkv6_ref``, the same function, which would be one step per token here.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.common import (aligned16, launch, load, on_cpu,
                                        require)
from repro_torch.kernels.wkv6.ref import wkv6_chunked

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {"wkv6_fwd": [_P] * 7 + [_I] * 5 + [_P]}
HEAD_DIMS = (16, 64)  # rwkv6-3b's smoke and full heads
DTYPES = (torch.bfloat16, torch.float32)


def wkv6_fwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor, chunk: int):
    """The forward alone: K4 on CUDA tensors, ``wkv6_chunked`` on CPU ones."""
    if on_cpu(r, k, v, w, u):
        return wkv6_chunked(r, k, v, w, u, chunk)
    B, S, H, dh = r.shape
    require(r.dtype in DTYPES and r.dtype == k.dtype == v.dtype == w.dtype,
            f"wkv6 kernel takes r, k, v, w all bfloat16 or all float32, got "
            f"{r.dtype}/{k.dtype}/{v.dtype}/{w.dtype}")
    require(tuple(k.shape) == tuple(v.shape) == tuple(w.shape) == (B, S, H, dh)
            and S >= 1, f"wkv6 shapes: r {tuple(r.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)}, w {tuple(w.shape)}")
    require(u.dtype == torch.float32 and tuple(u.shape) == (H, dh),
            f"wkv6 u must be float32 of shape ({H}, {dh}), got {u.dtype} "
            f"{tuple(u.shape)}")
    require(dh in HEAD_DIMS, f"wkv6 kernel takes head_dim in {HEAD_DIMS}, "
                             f"got {dh}")
    require(all(t.is_contiguous() for t in (r, k, v, w, u)),
            "wkv6 kernel takes contiguous tensors")
    require(aligned16(r, k, v, w),
            "wkv6 kernel copies 16 bytes at a time: r, k, v, w must be "
            "16-byte aligned")
    y = torch.empty_like(r)
    state = torch.empty((B, H, dh, dh), dtype=torch.float32, device=r.device)
    lib = load("wkv6", _ARGTYPES)
    launch("wkv6", lib.wkv6_fwd, r.device, r.data_ptr(), k.data_ptr(),
           v.data_ptr(), w.data_ptr(), u.data_ptr(), y.data_ptr(),
           state.data_ptr(), B, S, H, dh, int(r.dtype == torch.bfloat16))
    return y, state


def wkv6_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, u: torch.Tensor, chunk: int, g: torch.Tensor):
    """(dr, dk, dv, dw, du), each in its input's dtype: the vjp of
    ``wkv6_chunked``'s y at ``chunk`` against the cotangent ``g``."""
    with torch.enable_grad():
        ins = tuple(t.detach().requires_grad_() for t in (r, k, v, w, u))
        return torch.autograd.grad(wkv6_chunked(*ins, chunk)[0], ins, g)


class _WKV6(torch.autograd.Function):
    @staticmethod
    def forward(ctx, r, k, v, w, u, chunk):
        ctx.save_for_backward(r, k, v, w, u)
        ctx.chunk = chunk
        y, state = wkv6_fwd(r, k, v, w, u, chunk)
        ctx.mark_non_differentiable(state)
        return y, state

    @staticmethod
    def backward(ctx, g, _g_state):
        return (*wkv6_bwd(*ctx.saved_tensors, ctx.chunk, g), None)


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor, chunk: int):
    """r/k/v/w: (B, S, H, dh), w the per-step decay in (0, 1); u: (H, dh)
    fp32. Returns (y (B, S, H, dh) in r's dtype, state (B, H, dh, dh) fp32).

    ``chunk`` sets the plain version's blocks of steps; the kernel's chunk
    (64 tokens) and sub-chunk (16) are fixed in ``csrc/wkv6.cu``, the same
    function up to its TF32 products' rounding. y is differentiable in r, k,
    v, w and u; the final state is not (no caller trains through it).
    """
    return _WKV6.apply(r, k, v, w, u, chunk)
